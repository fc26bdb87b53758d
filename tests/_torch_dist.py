"""Multi-process checks of the port's mesh path on the CPU (gloo).

The test modules write their inputs (the port's params, made from JAX's
random init, and numpy inputs) into a work directory with ``torch.save``,
then ``run_group`` starts ``world`` ranks of this file, each
``python _torch_dist.py <check> <rank> <world> <workdir>``. A rank joins
a gloo group over a ``FileStore`` in the work directory (so xdist workers
never collide on a port), runs one thread, calls the named check, and
saves what it computed as ``out_<rank>.pt``; the test compares those with
JAX's outputs. This module imports no JAX, so a rank starts in about a
second; every check of a test module runs in one group.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]


def run_group(check: str, world: int, workdir, timeout: float = 240.0, meanwhile=None):
    """Run ``check`` on ``world`` gloo ranks: (every rank's saved output in
    rank order, ``meanwhile()``'s value), ``meanwhile`` running in this
    process while the ranks do (the test's JAX references). A rank that
    fails or hangs fails the caller with its output."""
    workdir = Path(workdir)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen([sys.executable, str(Path(__file__)), check, str(r), str(world),
                               str(workdir)], env=env, cwd=str(REPO), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        value = meanwhile() if meanwhile is not None else None
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of {check} exited {p.returncode}:\n{logs[r][-6000:]}")
    return [torch.load(workdir / f"out_{r}.pt", weights_only=False) for r in range(world)], value


# --------------------------------------------------------------------- checks
# Each check(rank, workdir) -> the dict saved for the test.


def _load(workdir):
    return torch.load(Path(workdir) / "inputs.pt", weights_only=False)


def _logits(params, cfg, ids, pos, **kw):
    from open_o3_video_tpu_torch.models.qwen25vl import model as TM

    with torch.no_grad():
        out, _ = TM.forward(params, cfg, torch.as_tensor(ids), torch.as_tensor(pos),
                            attn_impl="torch", **kw)
    return out.numpy()


def check_parallel(rank: int, workdir) -> dict:
    """tensor = 2 (mesh data 2 x tensor 2: each pair a tensor group) and
    fsdp 2 x tensor 2: the decoder's logits, the tower's rows (through
    ``forward`` with an image), the mixtures' logits under expert
    parallelism, K7's plain version on N and K shards, the unsharded
    export, and the distributed helpers."""
    from open_o3_video_tpu_torch.models.aria import model as AM
    from open_o3_video_tpu_torch.models.qwen25vl import model as TM
    from open_o3_video_tpu_torch.ops import int4 as I4
    from open_o3_video_tpu_torch.ops.sharded import Sharded
    from open_o3_video_tpu_torch.parallel import distributed as D
    from open_o3_video_tpu_torch.parallel import (gather_params, make_mesh, replicate,
                                                  replicate_scalars, shard_params)
    from open_o3_video_tpu_torch.train.lora import apply_adapters

    inp = _load(workdir)
    out: dict = {}
    for name, shape in (("tp", (2, 1, 2)), ("fsdp_tp", (1, 2, 2))):
        mesh = make_mesh(*shape)
        res = {}
        cfg, params = inp["qwen25"]
        sharded = shard_params(params, mesh, cfg)
        res["logits"] = _logits(sharded, cfg, inp["ids"], inp["pos"])
        res["vision_logits"] = _logits(sharded, cfg, inp["vids"], inp["vpos"],
                                       pixel_patches=torch.as_tensor(inp["patches"]),
                                       grid_thw=inp["grid"])
        with torch.no_grad():
            res["tower"] = TM.encode_vision(sharded, cfg, torch.as_tensor(inp["patches"]),
                                            inp["grid"], impl="torch").numpy()
        back = gather_params(sharded, mesh, cfg)
        res["export_equal"] = _trees_equal(back, params)
        mesh.collectives.clear()
        cfg3, p3 = inp["qwen3_moe"]
        res["moe_logits"] = _logits(shard_params(p3, mesh, cfg3), cfg3, inp["ids"], inp["pos"])
        res["moe_collectives"] = dict(mesh.collectives)
        cfga, pa = inp["aria"]
        with torch.no_grad():
            lg, _ = AM.forward(shard_params(pa, mesh, cfga), cfga,
                               torch.as_tensor(inp["aria_ids"]),
                               pixel_values=torch.as_tensor(inp["aria_pixels"]),
                               attn_impl="torch")
        res["aria_logits"] = lg.numpy()
        cfgq, pq = inp["qwen25_int4"]
        sq = shard_params(pq, mesh, cfgq)
        res["int4_logits"] = _logits(sq, cfgq, inp["ids"], inp["pos"])
        res["int4_specs"] = {k: v.specs for k, v in sq["text"]["layers"][0].items()
                             if isinstance(v, Sharded)}
        res["int4_export_equal"] = _trees_equal(gather_params(sq, mesh, cfgq), pq)
        cfg8, p8 = inp["qwen25_int8"]
        res["int8_logits"] = _logits(shard_params(p8, mesh, cfg8), cfg8, inp["ids"], inp["pos"])
        lora = apply_adapters(params, inp["adapters"], inp["lora_scale"])
        res["lora_logits"] = _logits(shard_params(lora, mesh, cfg), cfg, inp["ids"], inp["pos"])
        # K7's plain version on an N shard and on a K shard of whole groups
        w = I4.Int4Linear(*[torch.as_tensor(a) for a in inp["k7_w"]])
        x = torch.as_tensor(inp["k7_x"])
        t, r = mesh.shape["tensor"], mesh.rank("tensor")
        n = w.w_p.shape[1] // t
        wn = I4.Int4Linear(w.w_p[:, r * n:(r + 1) * n], w.scale[:, r * n:(r + 1) * n])
        res["k7_n"] = mesh.all_gather(I4.int4_dense(x, wn, impl="torch"), "tensor").numpy()
        g = w.scale.shape[0] // t
        wk = I4.Int4Linear(w.w_p[r * g * 64:(r + 1) * g * 64], w.scale[r * g:(r + 1) * g])
        xk = x[:, r * g * 128:(r + 1) * g * 128]
        res["k7_k"] = mesh.all_reduce(I4.int4_dense(xk, wk, impl="torch").float(),
                                      "tensor").numpy()
        out[name] = res
    # the helpers
    out["hosts_ok"] = (D.all_hosts_ok(True), D.all_hosts_ok(rank != 1))
    D.assert_in_sync(np.arange(4), "same")
    try:
        D.assert_in_sync(np.arange(4) + (rank == 2), "planted")
        out["divergence"] = None
    except RuntimeError as e:
        out["divergence"] = str(e)
    mesh = make_mesh(2, 1, 2)
    g = D.put_global(np.full((2, 3), mesh.rank("data"), np.float32), mesh, ("data", None))
    out["global"] = (tuple(g.shape), g.full_tensor().numpy())
    out["replica_broadcast"] = mesh.broadcast(torch.tensor([rank])).item()
    out["scalar"] = D.scalar(D.put_global(np.full((1,), 2.5, np.float32), mesh, (None,)))
    tree = {"w": torch.full((2,), float(rank)), "step": torch.tensor(rank), "n": [rank]}
    out["replicated"] = replicate({k: v.clone() for k, v in tree.items() if k != "n"}, mesh)
    out["replicated_scalars"] = replicate_scalars(tree, mesh)
    D.sync("done")
    out["hybrid"] = dict(D.make_hybrid_mesh(tensor=2, dcn_data=2).shape)
    return out


def check_engine(rank: int, workdir) -> dict:
    """Two ranks: ``InferenceEngine`` at tensor = 2 (greedy, float32 arena)
    beside the mesh-less engine on the same requests; the DP fleet at
    data = 2 (``InferenceEngine`` and ``QwenVLEngine`` with
    ``batch_axis="data"``, 4 slots: 2 a rank); ``EngineJudge`` at
    tensor = 2."""
    from open_o3_video_tpu_torch.data.processor import ByteTokenizer, O3VideoProcessor
    from open_o3_video_tpu_torch.engine import InferenceEngine, Request, SamplingParams
    from open_o3_video_tpu_torch.eval.judge import EngineJudge
    from open_o3_video_tpu_torch.eval.model_engine import QwenVLEngine
    from open_o3_video_tpu_torch.parallel import make_mesh

    inp = _load(workdir)
    cfg, params = inp["qwen25"]
    kw = dict(prompt_buckets=inp["buckets"], cache_dtype=torch.float32)
    greedy = SamplingParams(**inp["greedy"])
    out: dict = {}
    tp = make_mesh(1, 1, 2)
    reqs = [Request(**r) for r in inp["requests"]]
    out["tp"] = InferenceEngine(params, cfg, mesh=tp, **kw).generate(reqs, greedy,
                                                                     return_logprobs=True)
    out["tp_collectives"] = dict(tp.collectives)
    out["plain"] = InferenceEngine(params, cfg, **kw).generate(reqs, greedy, return_logprobs=True)
    # the prefix cache (a block of the shared 30 tokens, then each suffix)
    # and greedy speculation on the local shards of the arena
    shared = list(range(60, 90))
    pair = [Request(input_ids=shared + [5, 6]), Request(input_ids=shared + [7, 8, 9])]
    for name, extra, batch in (("prefix", {"prefix_cache_min": 8}, pair),
                               ("spec", {"spec_decode": True}, reqs[1:])):
        eng = InferenceEngine(params, cfg, mesh=tp, **extra, **kw)
        out[f"{name}_tp"] = eng.generate(batch, greedy)
        out[f"{name}_counts"] = (eng.counters["prefix_blocks"], eng.spec_stats["verify_steps"])
        out[f"{name}_plain"] = InferenceEngine(params, cfg, **extra, **kw).generate(batch, greedy)
    dp = make_mesh(2, 1, 1)
    fleet_reqs = [Request(**r) for r in inp["fleet_requests"]]
    six = SamplingParams(temperature=0.0, max_tokens=6)
    fleet = InferenceEngine(params, cfg, mesh=dp, batch_axis="data", max_slots=4, **kw)
    out["fleet"] = fleet.generate(fleet_reqs, six, return_logprobs=True)
    out["fleet_admitted"] = fleet.counters["admissions"]
    out["fleet_plain"] = InferenceEngine(params, cfg, max_slots=4, **kw).generate(
        fleet_reqs, six, return_logprobs=True)
    proc = O3VideoProcessor(tokenizer=ByteTokenizer.for_config(cfg))
    texts = [{"prompt": p} for p in inp["prompts"]]
    qkw = dict(cfg=cfg, processor=proc, max_slots=4, temperature=0.0, max_tokens=6, **kw)
    out["qwenvl_fleet"] = QwenVLEngine(params, mesh=dp, batch_axis="data",
                                       **qkw).inference_wo_process_batch(texts)
    out["qwenvl_plain"] = QwenVLEngine(params, **qkw).inference_wo_process_batch(texts)
    jkw = dict(max_new_tokens=4, cfg=cfg, processor=proc)
    judges = (EngineJudge(params, mesh=tp, **jkw), EngineJudge(params, **jkw))
    out["judge_scores"] = [j.batch(inp["jobs"]) for j in judges]
    out["judge_tokens"] = [
        [o["token_ids"] for o in j.engine.generate([j._request(*job) for job in inp["jobs"]],
                                                   j.sampling)] for j in judges]
    return out


def _with_grads(tree):
    """``tree`` with each tensor (and each ``Sharded`` part) replaced by its
    ``.grad``, for ``gather_params``."""
    from open_o3_video_tpu_torch.ops.sharded import Sharded

    if isinstance(tree, dict):
        return {k: _with_grads(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_with_grads(v) for v in tree]
    if isinstance(tree, Sharded):
        return Sharded({k: v.grad for k, v in tree.parts.items()}, tree.specs, tree.kind,
                       tree.mesh, tree.shape, x_split=tree.x_split, out_full=tree.out_full,
                       n_cols=tree.n_cols)
    return tree.grad


def _numpy_tree(tree):
    from open_o3_video_tpu_torch.models.qwen25vl import params as TP

    with torch.no_grad():
        return TP.to_jax_layout(tree)


# The meshes of the training checks on four ranks: data x tensor, fsdp x
# tensor, data x fsdp, and tensor 4 (each rank's query heads read a KV head
# that a neighbour holds too: ``HEADS``).
TRAIN_MESHES = {"dp2_tp2": (2, 1, 2), "fsdp2_tp2": (1, 2, 2), "dp2_fsdp2": (2, 2, 1),
                "tp4": (1, 1, 4)}


def check_train_mesh(rank: int, workdir) -> dict:
    """Four ranks: one SFT step, full fine-tune and PEFT, on each of
    ``TRAIN_MESHES`` (the gradients gathered, the updated params and
    adapters, loss and norm); a checkpoint saved at tensor 2, restored at
    tensor 1 and back; a PEFT GSPO step at data 2 x tensor 2 with canned
    rollouts through the engine's row sharding; a planted divergence; the
    engine's row sharding and its replicated fallback."""
    import torch.distributed as dist

    from open_o3_video_tpu_torch.engine import InferenceEngine, Request, SamplingParams
    from open_o3_video_tpu_torch.grounding.rewards import REWARD_REGISTRY
    from open_o3_video_tpu_torch.models.qwen25vl import params as TP
    from open_o3_video_tpu_torch.parallel import gather_params, make_mesh, shard_params
    from open_o3_video_tpu_torch.train import checkpoint as CK
    from open_o3_video_tpu_torch.train import gspo as TG
    from open_o3_video_tpu_torch.train import sft as S
    from open_o3_video_tpu_torch.train.lora import LoraConfig, adapter_leaves

    inp = _load(workdir)
    cfg, params = inp["cfg"], inp["params"]
    tc = S.SFTConfig(learning_rate=inp["lr"], logp_chunk=inp["logp_chunk"])
    fresh = lambda: TP.from_jax_params(TP.to_jax_layout(params), cfg, torch.device("cpu"))  # noqa: E731
    out: dict = {}
    meshes = {name: make_mesh(*shape) for name, shape in TRAIN_MESHES.items()}
    for name, mesh in meshes.items():
        res = {}
        local = S.shard_batch(inp["batch"], mesh)
        p = TP.trainable(shard_params(fresh(), mesh, cfg))
        m = S.loss_and_grads(p, cfg, tc, local, mesh=mesh)
        res["grads"] = _numpy_tree(gather_params(_with_grads(p), mesh, cfg))
        res["grad_loss"] = (float(m["loss"]), float(m["grad_norm"]), int(m["num_target_tokens"]))
        p = TP.trainable(shard_params(fresh(), mesh, cfg))
        full = S.SFTConfig(learning_rate=inp["lr_full"], logp_chunk=inp["logp_chunk"])
        fopt = S.make_optimizer(full)
        _, _, m = S.make_train_step(cfg, full, fopt, mesh=mesh)(p, fopt.init(p), local)
        opt = S.make_optimizer(tc)
        res["step"] = (float(m["loss"]), float(m["grad_norm"]))
        with torch.no_grad():
            res["params"] = _numpy_tree(gather_params(p, mesh, cfg))
        base = shard_params(fresh(), mesh, cfg)
        ad = TP.adapters_from_jax(inp["adapters"], torch.device("cpu"))
        state = opt.init(adapter_leaves(ad))
        _, _, m = S.make_lora_train_step(cfg, tc, opt, inp["scale"], mesh=mesh)(
            ad, state, local, base)
        res["peft"] = (float(m["loss"]), float(m["grad_norm"]))
        res["adapters"] = _numpy_tree(ad)
        res["collectives"] = dict(mesh.collectives)
        out[name] = res

    # a checkpoint of a full fine-tune step at tensor 2 (dp2_tp2), restored
    # at tensor 1 and back
    mesh = meshes["dp2_tp2"]
    p = TP.trainable(shard_params(fresh(), mesh, cfg))
    opt = S.make_optimizer(tc)
    st = opt.init(p)
    S.make_train_step(cfg, tc, opt, mesh=mesh)(p, st, S.shard_batch(inp["batch"], mesh))
    ck = str(Path(workdir) / "ckpt")
    CK.save_checkpoint(ck, 1, {"params": p, "opt_state": st, "meta": {"step": 1}}, mesh=mesh,
                       cfg=cfg)
    dist.barrier()
    one = TP.trainable(fresh())
    st1 = opt.init(one)
    CK.restore_checkpoint(ck, 1, target={"params": one, "opt_state": st1, "meta": {"step": 0}})
    with torch.no_grad():
        whole = gather_params(p, mesh, cfg)
    moments = lambda s: [x for v in s["adamw"].state.values() for k, x in sorted(v.items())  # noqa: E731
                         if k != "step"]
    out["ckpt_to_one"] = (all(torch.equal(a, b) for a, b in zip(TP.leaves(one),
                                                                 TP.leaves(whole))),
                          len(moments(st1)))
    if rank == 0:
        CK.save_checkpoint(ck, 2, {"params": one, "opt_state": st1, "meta": {"step": 2}})
    dist.barrier()
    back = TP.trainable(shard_params(fresh(), mesh, cfg))
    st2 = opt.init(back)
    CK.restore_checkpoint(ck, 2, target={"params": back, "opt_state": st2, "meta": {"step": 0}},
                          mesh=mesh, cfg=cfg)
    out["ckpt_back"] = (all(torch.equal(a, b) for a, b in zip(TP.leaves(back), TP.leaves(p))),
                        all(torch.equal(a, b) for a, b in zip(moments(st2), moments(st))),
                        len(moments(st2)))

    # GSPO, PEFT, at data 2 x tensor 2: canned rollouts for this rank's rows
    gcfg, gparams = inp["gspo_cfg"], inp["gspo_params"]
    table = {tuple(ids): t for ids, t in zip(inp["canned_ids"], inp["traces"])}
    record: dict = {}

    def rec(fn):
        def inner(**kw):
            vals = fn(**kw)
            record.setdefault(fn.__name__, []).extend(list(vals))
            return vals
        inner.__name__ = fn.__name__
        return inner

    trainer = TG.GSPOTrainer(
        TP.from_jax_params(gparams, gcfg, torch.device("cpu")), None, gcfg,
        TG.GSPOConfig(**inp["gspo_kw"]), detokenize=lambda ids: table[tuple(ids)],
        reward_funcs=[rec(f) for f in REWARD_REGISTRY.values()], mesh=mesh,
        lora=LoraConfig(rank=4, alpha=8.0))
    trainer.adapters = TP.adapters_from_jax(inp["gspo_adapters"], torch.device("cpu"))
    trainer.opt_state = trainer.optimizer.init(adapter_leaves(trainer.adapters))
    lo = mesh.rank("data") * 2

    def canned(requests, *_a):
        return [{"token_ids": list(ids), "num_prompt_tokens": 0}
                for ids in inp["canned_ids"][lo:lo + len(requests)]]

    trainer.engine._generate = canned
    m = trainer.step(inp["gspo_sample"], global_step=0, max_steps=4)
    out["gspo"] = {"metrics": m, "adapters": _numpy_tree(trainer.adapters),
                   "layout": trainer.engine.last_rollout_layout,
                   "rewards": trainer.last_step["rewards_per_func"], "record": record}
    planted = dict(inp["gspo_sample"])
    planted["input_ids"] = list(planted["input_ids"]) + [5] * (rank == 1)
    try:
        trainer.step(planted, global_step=1, max_steps=4)
        out["divergence"] = None
    except RuntimeError as e:
        out["divergence"] = str(e)

    # the engine's row sharding: 4 rows shard over data 2, 3 run replicated
    kw = dict(prompt_buckets=(64,), cache_dtype=torch.float32)
    greedy = SamplingParams(temperature=0.0, max_tokens=5)
    eng = InferenceEngine(params, cfg, mesh=mesh, rollout_shard_axis="data", **kw)
    plain = InferenceEngine(params, cfg, **kw)
    for n in (4, 3):
        reqs = [Request(input_ids=list(range(40 + i, 52 + 2 * i))) for i in range(n)]
        got = eng.generate(reqs, greedy)
        out[f"rows_{n}"] = (eng.last_rollout_layout, [o["token_ids"] for o in got],
                            [o["token_ids"] for o in plain.generate(reqs, greedy)])
    return out


def check_context(rank: int, workdir) -> dict:
    """Four ranks: ring attention at context 2 (data 2 x context 2) and 4,
    both versions, forward and backward, each rank's block gathered over
    the axis; ``cp_text_forward``, ``cp_per_token_logps`` and the logps'
    gradients (summed over ``context`` by ``sync_grads``) on the tiny
    decoder."""
    from open_o3_video_tpu_torch.models.qwen25vl import params as TP
    from open_o3_video_tpu_torch.ops.ring_attention import ring_attention
    from open_o3_video_tpu_torch.parallel import make_mesh, shard_params
    from open_o3_video_tpu_torch.parallel.context import cp_per_token_logps, cp_text_forward
    from open_o3_video_tpu_torch.parallel.mesh import placements, sync_grads

    inp = _load(workdir)
    out: dict = {}
    meshes = {2: make_mesh(data=2, fsdp=1, context=2), 4: make_mesh(data=1, fsdp=1, context=4)}
    for n, mesh in meshes.items():
        c = mesh.rank("context")
        group = mesh.groups["context"]

        def block(x, dim=1):
            per = x.shape[dim] // n
            return x.narrow(dim, c * per, per)

        def whole(x, dim=1):
            return mesh.all_gather(x.detach(), "context", dim=dim)

        for case, (q, k, v, valid, dout) in inp["attention"].items():
            S = q.shape[1]
            pos = torch.arange(S).expand(q.shape[0], S)
            for impl in ("torch", "auto"):
                ql, kl, vl = (block(torch.as_tensor(x)).clone().requires_grad_()
                              for x in (q, k, v))
                o = ring_attention(ql, kl, vl, block(pos), block(pos),
                                   block(torch.as_tensor(valid)), group, impl=impl)
                o.backward(block(torch.as_tensor(dout)))
                out[(n, case, impl)] = tuple(whole(x).numpy() for x in
                                             (o, ql.grad, kl.grad, vl.grad))
        cfg, params = inp["cfg"], inp["params"]
        embeds, pos3, valid, targets = (torch.as_tensor(inp[k]) for k in
                                        ("embeds", "pos", "valid", "targets"))
        with torch.no_grad():
            hidden = cp_text_forward(params["text"], cfg.text, embeds, pos3, mesh,
                                     attn_valid=valid)
        out[(n, "hidden")] = whole(hidden).numpy()
        sharded = TP.trainable(shard_params(params, mesh, cfg))
        leaves = [x for x in TP.leaves(sharded["text"]) if x.requires_grad]
        for x in leaves:  # a leaf no axis splits is the caller's, shared by both meshes
            x.grad = None
        logps = cp_per_token_logps(sharded["text"], cfg.text, embeds, pos3, targets, mesh,
                                   attn_valid=valid)
        (logps * torch.as_tensor(inp["weights"])).sum().backward()
        for x in leaves:
            if x.grad is None:
                x.grad = torch.zeros_like(x)
        sync_grads(leaves, mesh, cfg, placements(sharded))
        out[(n, "logps")] = logps.detach().numpy()
        # the data replicas read the same rows here: their sum counts them twice
        out[(n, "grads")] = [x.grad.numpy() / mesh.shape["data"] for x in leaves]
    return out


def check_pipeline(rank: int, workdir) -> dict:
    """Two ranks, two stages: ``pipeline_text_forward`` over 2 microbatches
    (the hidden states, and the gradients of a weighted sum of them w.r.t.
    this stage's layers and the inputs), and ``dryrun_pipeline_step``'s
    own check against its sequential step."""
    from open_o3_video_tpu_torch.parallel.pipeline import (dryrun_pipeline_step, make_pipe_mesh,
                                                           shard_pipeline_params,
                                                           stack_pipeline_params)

    inp = _load(workdir)
    cfg, params = inp["cfg"], inp["params"]
    mesh = make_pipe_mesh(2)
    stacked = shard_pipeline_params(stack_pipeline_params(params["text"]["layers"]), mesh)
    for x in stacked.values():
        x.requires_grad_(True)
    embeds = torch.as_tensor(inp["embeds"]).requires_grad_()
    from open_o3_video_tpu_torch.parallel.pipeline import pipeline_text_forward

    hidden = pipeline_text_forward(stacked, cfg.text, embeds, torch.as_tensor(inp["pos"]), mesh,
                                   n_microbatches=2, final_norm=params["text"]["final_norm"])
    (hidden * torch.as_tensor(inp["weights"])).sum().backward()
    return {"hidden": hidden.detach().numpy(), "stage": mesh.rank("pipe"),
            "grads": {k: v.grad.numpy() for k, v in stacked.items()},
            "embeds_grad": embeds.grad.numpy(),
            "dryrun": dryrun_pipeline_step(2, 2, check_sequential=True)}


def _trees_equal(a, b) -> bool:
    from open_o3_video_tpu_torch.ops.quant import LoraLinear, stored_tensors

    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_trees_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_trees_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    if isinstance(a, LoraLinear):
        return a.scale == b.scale and all(_trees_equal(getattr(a, k), getattr(b, k))
                                         for k in ("base", "a", "b"))
    if a is None or isinstance(a, (int, float)):
        return a == b
    return type(a) is type(b) and all(torch.equal(x, y) for x, y in
                                      zip(stored_tensors(a), stored_tensors(b)))


def _main() -> None:
    check, rank, world, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    import torch.distributed as dist

    store = dist.FileStore(str(Path(workdir) / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        out = globals()[f"check_{check}"](rank, workdir)
        torch.save(out, Path(workdir) / f"out_{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main()
