"""The port's mesh (``open_o3_video_tpu_torch/parallel``) against the JAX
package's (``open_o3_video_tpu/parallel``).

- Placements, with no process: every leaf's placement from
  ``param_sharding_rules`` equals JAX's at (data, fsdp, tensor) = (1,2,4),
  (1,8,1), (2,2,2) and (1,1,8), for the tiny Qwen2.5-VL, its int8 and
  (at a width K7 takes) int4 trees, LoRA on every decoder matrix over the
  int8 base, ``tiny_qwen3``, ``tiny_qwen3_moe`` and ``tiny_aria``. The
  only differences are the port's head alignment, listed in
  ``_departure``: where the query heads do not divide over ``tensor``
  attention stays replicated; where only the KV heads do not, each rank
  holds the KV head its query heads read (``HEADS``). (The tower's qkv
  permutation changes the layout inside a shard, not the placement.)
- One group of 4 gloo ranks (``_torch_dist.check_parallel``), each check
  on a mesh of data 2 x tensor 2 ("tp": each pair a tensor group) and of
  fsdp 2 x tensor 2 ("fsdp_tp"), in float32: the decoder's logits, the
  logits of an image request and the tower's rows against JAX's unsharded
  ``forward`` and ``encode_vision`` within 2e-4 (JAX's own bound,
  ``tests/test_parallel.py``; the image request against the port's
  unsharded forward); ``tiny_qwen3_moe``'s and ``tiny_aria``'s
  logits under expert parallelism against JAX's; int8 and int4 models
  against the port's unsharded forward (int4 within bf16's rounding: a
  local shard narrower than 128 columns takes JAX's dequantized product,
  as on JAX's mesh); K7's plain version on N shards (equal) and on K
  shards of whole groups (within each partial's bf16 rounding); the
  unsharded export byte for byte; the distributed helpers.
"""

import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

from _torch_dist import run_group
from _torch_parity import family_pair, model_pair

from open_o3_video_tpu_torch.models.aria import config as AC
from open_o3_video_tpu_torch.models.aria import params as AP
from open_o3_video_tpu_torch.models.qwen25vl import config as TC
from open_o3_video_tpu_torch.models.qwen25vl import model as TM
from open_o3_video_tpu_torch.models.qwen25vl import params as TP
from open_o3_video_tpu_torch.ops import int4 as I4
from open_o3_video_tpu_torch.ops.sharded import HEADS
from open_o3_video_tpu_torch.parallel import mesh as PM
from open_o3_video_tpu_torch.train import lora as TL

ATOL = 2e-4
MESHES = [(1, 2, 4), (1, 8, 1), (2, 2, 2), (1, 1, 8)]
CPU = torch.device("cpu")


def _int4_width(cfg):
    """The tiny config widened so that K7 takes its decoder matrices."""
    return dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, hidden_size=256, intermediate_size=512,
                                      mrope_section=(8, 12, 12)),
        vision=dataclasses.replace(cfg.vision, out_hidden_size=256))


@functools.cache
def _trees(name):
    """(JAX shape tree, port tree, port config) of one tree kind."""
    import jax

    from open_o3_video_tpu.models.aria import params as JAP
    from open_o3_video_tpu.models.aria import tiny_aria as jax_tiny_aria
    from open_o3_video_tpu.models.qwen25vl import config as JC
    from open_o3_video_tpu.models.qwen25vl import params as JP
    from open_o3_video_tpu.train import lora as JL

    if name == "aria":
        return (jax.eval_shape(lambda: JAP.init(jax_tiny_aria())), AP.init(AC.tiny_aria(), 0, CPU),
                AC.tiny_aria())
    family = "tiny" if name in ("qwen25", "int8", "int4", "lora") else name
    jcfg = JC.Qwen25VLConfig.tiny() if family == "tiny" else getattr(JC, family)()
    tcfg = TC.Qwen25VLConfig.tiny() if family == "tiny" else getattr(TC, family)()
    quant = {"int8": "int8", "int4": "int4", "lora": "int8"}.get(name, False)
    if name == "int4":
        jcfg, tcfg = _int4_width(jcfg), _int4_width(tcfg)
    jtree = jax.eval_shape(lambda: JP.init(jcfg, 0, quantize_text=quant))
    ttree = TP.init(tcfg, 0, CPU, quantize_text=quant)
    if name == "lora":
        targets = ("q_w", "k_w", "v_w", "o_w", "gate_w", "up_w", "down_w")
        jtree = jax.eval_shape(lambda t: JL.apply_adapters(
            t, JL.init_adapters(t, JL.LoraConfig(target_modules=targets)), 2.0), jtree)
        ttree = TL.apply_adapters(
            ttree, TL.init_adapters(ttree, TL.LoraConfig(target_modules=targets)), 2.0)
    return jtree, ttree, tcfg


def _flat_jax(specs) -> dict:
    import jax
    from jax.sharding import PartitionSpec

    from open_o3_video_tpu.parallel.mesh import _path_str

    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {_path_str(p): tuple(s) for p, s in leaves}


def _flat_port(specs, path="") -> dict:
    if isinstance(specs, dict):
        out = {}
        for k, v in specs.items():
            out.update(_flat_port(v, f"{path}/{k}" if path else str(k)))
        return out
    if isinstance(specs, list):
        out = {}
        for i, v in enumerate(specs):
            out.update(_flat_port(v, f"{path}/{i}" if path else str(i)))
        return out
    return {path: specs}


def _departure(path: str, jax_spec: tuple, port_spec: tuple, cfg, tensor: int) -> bool:
    """Whether the port's placement differs from JAX's only by head
    alignment: one entry on the heads' axis, "tensor" in JAX's, None (the
    heads do not divide) or HEADS (only the KV heads do not) in the
    port's."""
    plan = PM.head_plan(cfg, tensor)
    diff = [d for d, (a, b) in enumerate(zip(jax_spec, port_spec)) if a != b]
    if len(jax_spec) != len(port_spec) or len(diff) != 1 or jax_spec[diff[0]] != "tensor":
        return False
    new = port_spec[diff[0]]
    if path.startswith("visual/"):
        return new is None and not plan.vision
    if plan.text == "replicated":
        return new is None
    return new == HEADS and plan.text == "kv_heads" and PM._KV.search(path) is not None


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("tree", ["qwen25", "int8", "int4", "lora", "tiny_qwen3",
                                  "tiny_qwen3_moe", "aria"])
def test_placements_equal_jaxs_but_for_head_alignment(tree, mesh):
    from open_o3_video_tpu.parallel.mesh import param_sharding_rules as jax_rules

    jtree, ttree, tcfg = _trees(tree)
    sizes = types.SimpleNamespace(shape=dict(zip(("data", "fsdp", "tensor"), mesh)))
    theirs = _flat_jax(jax_rules(jtree, sizes))
    ours = _flat_port(PM.param_sharding_rules(ttree, sizes, tcfg))
    assert ours.keys() == theirs.keys()
    departed = [p for p in ours if ours[p] != theirs[p]]
    for p in departed:
        assert _departure(p, theirs[p], ours[p], tcfg, mesh[2]), (p, theirs[p], ours[p])
    # Without the config the port's rules are JAX's, leaf for leaf.
    assert _flat_port(PM.param_sharding_rules(ttree, sizes)) == theirs
    if tree == "qwen25" and mesh[2] == 8:  # 4 query heads over 8 ranks
        assert "text/layers/0/q_w" in departed and "visual/blocks/0/qkv_w" in departed


def test_head_plans():
    """The three ways attention splits (tiny: 4 query heads over 2 KV heads;
    the 7B's 28/4 at tensor = 8 stays replicated, as its 28 query heads do
    not divide; the 72B's 64/8 at 8 is even; the 30B-A3B's 32/4 at 8
    holds one KV head per rank)."""
    tiny = TC.Qwen25VLConfig.tiny()
    assert [PM.head_plan(tiny, t).text for t in (1, 2, 4, 8)] == [
        "even", "even", "kv_heads", "replicated"]
    plan = PM.head_plan(tiny, 4)
    assert [plan.kv_heads(tiny.text, r) for r in range(4)] == [(0, 1), (0, 1), (1, 1), (1, 1)]
    qwen7b = TC.Qwen25VLConfig()  # Qwen2.5-VL-7B's published widths
    assert PM.head_plan(qwen7b, 8).text == "replicated" and PM.head_plan(qwen7b, 4).text == "even"
    assert PM.head_plan(qwen7b, 8).vision  # 16 ViT heads
    moe = TC.Qwen25VLConfig.from_hf_dict(TC.QWEN3_VL_30B_A3B_INSTRUCT_CONFIG)
    assert PM.head_plan(moe, 8).text == "kv_heads"


def test_qkv_permutation_puts_each_ranks_heads_together():
    """[q|k|v] columns of 4 heads of 2 over 2 ranks: rank 0 holds q, k, v of
    heads 0-1, rank 1 of heads 2-3."""
    perm = PM._qkv_perm(24, 4, 2).tolist()
    assert perm == [0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 19,
                    4, 5, 6, 7, 12, 13, 14, 15, 20, 21, 22, 23]


# ------------------------------------------------------------ the rank group


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """JAX's references and the 4 ranks' outputs."""
    import jax.numpy as jnp

    from open_o3_video_tpu.models.aria import model as JAM
    from open_o3_video_tpu.models.aria import params as JAP
    from open_o3_video_tpu.models.aria import tiny_aria as jax_tiny_aria
    from open_o3_video_tpu.models.qwen25vl import model as JM

    work = tmp_path_factory.mktemp("parallel")
    r = np.random.default_rng(0)
    jcfg, jparams, tcfg, tparams = model_pair(0)
    j3, jp3, t3, tp3 = family_pair("tiny_qwen3_moe", 0)
    cfga = AC.tiny_aria()
    pa = AP.init(cfga, 2, CPU)
    jcfga = jax_tiny_aria()
    jpa = JAP.from_named_arrays(((n, t.numpy()) for n, t in AP.hf_named_tensors(pa, cfga)),
                                jcfga)
    ids = r.integers(5, 400, size=(2, 12))
    pos, _ = TM.get_rope_index(tcfg, ids)
    grid = np.array([[1, 8, 8]])
    patches = r.normal(0, 1, (64, tcfg.vision.patch_dim)).astype(np.float32)
    vids = np.array([[5, 6, tcfg.vision_start_token_id] + [tcfg.image_token_id] * 16
                     + [tcfg.vision_end_token_id, 7]])
    vpos, _ = TM.get_rope_index(tcfg, vids, image_grid_thw=grid)
    q = cfga.query_num(cfga.vision.num_patches_per_side ** 2)
    aria_ids = np.array([[9, 10, 11] + [cfga.image_token_id] * q + [12, 13]])
    s = cfga.vision.image_size
    aria_pixels = r.standard_normal((1, 3, s, s)).astype(np.float32)
    cfgq = _int4_width(tcfg)
    targets = ("q_w", "k_w", "v_w", "o_w", "gate_w", "up_w", "down_w")
    adapters = TL.init_adapters(tparams, TL.LoraConfig(rank=4, target_modules=targets),
                                dtype=torch.float32)
    for layer in adapters["layers"]:  # B = 0 would hide the delta
        for ab in layer.values():
            ab["b"] = torch.as_tensor(r.normal(0, 0.02, tuple(ab["b"].shape)), dtype=torch.float32)
    wk = I4.quantize_weight_int4(torch.as_tensor(r.normal(0, 0.02, (512, 256)), dtype=torch.float32))
    inputs = dict(
        qwen25=(tcfg, tparams), qwen3_moe=(t3, tp3), aria=(cfga, pa),
        qwen25_int4=(cfgq, TP.init(cfgq, 3, CPU, quantize_text="int4")),
        qwen25_int8=(tcfg, TP.init(tcfg, 4, CPU, quantize_text="int8")),
        adapters=adapters, lora_scale=2.0,
        ids=ids, pos=pos, grid=grid, patches=patches, vids=vids, vpos=vpos,
        aria_ids=aria_ids, aria_pixels=aria_pixels,
        k7_w=(wk.w_p.numpy(), wk.scale.numpy()),
        k7_x=r.normal(0, 1, (3, 512)).astype(np.float32))
    torch.save(inputs, work / "inputs.pt")

    def references():
        import jax

        def jlogits(params, cfg, i, p):
            fn = jax.jit(lambda prm, a, b: JM.forward(prm, cfg, a, b)[0])
            return np.asarray(fn(params, jnp.asarray(i), jnp.asarray(p)))

        def plogits(cfg, params, i=ids, p=pos, **kw):
            with torch.no_grad():
                return TM.forward(params, cfg, torch.as_tensor(i), torch.as_tensor(p),
                                  attn_impl="torch", **kw)[0].numpy()

        tower = jax.jit(lambda prm, x: JM.encode_vision(prm, jcfg, x, grid))
        aria = jax.jit(lambda prm, i, x: JAM.forward(prm, jcfga, i, pixel_values=x)[0])
        return {
            "logits": jlogits(jparams, jcfg, ids, pos),
            "tower": np.asarray(tower(jparams, jnp.asarray(patches))),
            "moe_logits": jlogits(jp3, j3, ids, pos),
            "aria_logits": np.asarray(aria(jpa, jnp.asarray(aria_ids), jnp.asarray(aria_pixels))),
            # the image request against the port's unsharded forward (held to
            # JAX's in test_torch_model.py)
            "vision_logits": plogits(tcfg, tparams, vids, vpos,
                                     pixel_patches=torch.as_tensor(patches), grid_thw=grid),
            "int4_logits": plogits(*inputs["qwen25_int4"]),
            "int8_logits": plogits(*inputs["qwen25_int8"]),
            "lora_logits": plogits(tcfg, TL.apply_adapters(tparams, adapters, 2.0)),
            "k7": I4.int4_dense(torch.as_tensor(inputs["k7_x"]), wk, impl="torch").numpy(),
        }

    return run_group("parallel", 4, work, meanwhile=references)


MESH_NAMES = ["tp", "fsdp_tp"]


@pytest.mark.parametrize("mesh", MESH_NAMES)
@pytest.mark.parametrize("key", ["logits", "vision_logits", "tower", "moe_logits", "aria_logits"])
def test_sharded_forward_matches_jaxs_unsharded(group, key, mesh):
    outs, ref = group
    for out in outs:
        np.testing.assert_allclose(out[mesh][key], ref[key], atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_quantized_models_on_the_mesh(group, mesh):
    """int8 (float32 sums) and LoRA on every decoder matrix (each adapter
    placed by its own rule): as close as float32; int4: within bf16's
    rounding of K7's outputs. Every int4 leaf is column-parallel, as JAX's
    rules place it, and o/down keep their packed rows whole."""
    outs, ref = group
    for out in outs:
        res = out[mesh]
        np.testing.assert_allclose(res["int8_logits"], ref["int8_logits"], atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(res["lora_logits"], ref["lora_logits"], atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(res["int4_logits"], ref["int4_logits"], atol=2e-2)
        assert res["int4_specs"]["o_w"]["w_p"] == (None, "tensor")
        assert res["int4_specs"]["q_w"]["w_p"] == ("fsdp", "tensor")


@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_k7_plain_on_n_and_k_shards(group, mesh):
    """An N shard's product is the unsharded product's columns; K shards of
    whole groups, summed, are within each partial's bf16 rounding."""
    outs, ref = group
    scale = np.abs(ref["k7"]).max()
    for out in outs:
        np.testing.assert_array_equal(out[mesh]["k7_n"], ref["k7"])
        np.testing.assert_allclose(out[mesh]["k7_k"], ref["k7"], atol=2 ** -7 * scale)


@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_the_unsharded_export_gives_back_the_bytes(group, mesh):
    """``gather_params`` undoes the qkv permutation and the KV head choice."""
    outs, _ = group
    assert all(out[mesh]["export_equal"] and out[mesh]["int4_export_equal"] for out in outs)


def test_expert_parallelism_reduces_once_a_layer(group):
    """tiny_qwen3_moe (2 layers of 4 experts over 2 ranks): per layer one
    all-reduce after attention and one for the experts' combine, plus the
    embedding's; the lm_head's logits gathered once."""
    outs, _ = group
    assert outs[0]["tp"]["moe_collectives"] == {"all_reduce": 5, "all_gather": 1}


def test_distributed_helpers(group):
    outs, _ = group
    for rank, out in enumerate(outs):
        assert out["hosts_ok"] == (True, False)
        msg = out["divergence"]
        assert msg and "planted" in msg and "[0.0, 1.0, 2.0, 3.0]" in msg and "[1.0, 2.0, 3.0, 4.0]" in msg
        shape, full = out["global"]
        assert shape == (4, 3)  # each data rank's 2 rows
        np.testing.assert_array_equal(full[:, 0], [0, 0, 1, 1])
        assert out["replica_broadcast"] == (0 if rank < 2 else 2)
        assert out["scalar"] == 2.5 and out["hybrid"] == {"data": 2, "fsdp": 1, "tensor": 2}
        assert out["replicated"]["w"].tolist() == [0.0, 0.0] and out["replicated"]["step"] == 0
        assert out["replicated_scalars"]["step"] == 0 and out["replicated_scalars"]["n"] == [rank]
        assert out["replicated_scalars"]["w"].tolist() == [float(rank)] * 2
