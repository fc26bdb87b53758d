"""Pipeline parallelism for the text decoder: GPipe over microbatches of the
batch on a ``pipe`` axis (counterpart of
``open_o3_video_tpu/parallel/pipeline.py``).

The L decoder layers are stacked into one (L, ...) tensor per parameter
(``stack_pipeline_params``) and cut over ``pipe``: each rank holds L /
n_stages contiguous layers (``shard_pipeline_params``). One process per
stage. At schedule step t, stage s applies its layers to microbatch t - s
(idle in the fill and drain: the GPipe bubble) and sends the activation to
stage s + 1; the last stage banks the results, and one all-reduce of its
buffer (every other stage adding zeros) replicates the output on every
stage, as JAX's masked ``psum``.

It is differentiable end to end: the sends and receives are autograd
functions whose backward sends the gradient back to the previous stage
(tagged by microbatch), each send's placeholder output is tied into the
stage's output with weight 0 so that its backward runs, and the inputs
enter through ``Mesh.copy_in``, so every stage holds the embeddings' whole
gradient. A gloo group moves a card's tensors through host copies.

Microbatches split the BATCH axis (the reference trains one sample per
device, run_grpo_video.sh:11-15). Attention inside a stage is the
decoder's: K3, exact under autograd, and K5 for its backward.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.qwen25vl.config import TextConfig
from ..models.qwen25vl.text import _attention_layer, _mlp
from ..ops.rms_norm import rms_norm
from ..ops.rope import mrope_cos_sin, mrope_cos_sin_interleaved
from .mesh import Mesh

PIPE = "pipe"


def stack_pipeline_params(layers: list) -> dict:
    """A homogeneous per-layer param list stacked into (L, ...) tensors;
    the leading axis is the pipeline axis."""
    return {k: torch.stack([layer[k] for layer in layers]) for k in layers[0]}


def unstack_pipeline_params(stacked: dict) -> list:
    """Inverse of ``stack_pipeline_params`` (for export)."""
    n = next(iter(stacked.values())).shape[0]
    return [{k: v[i] for k, v in stacked.items()} for i in range(n)]


def make_pipe_mesh(n_stages: int, device_type: Optional[str] = None) -> Mesh:
    """A one-axis ``pipe`` mesh over the initialized process group's ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    if dist.get_world_size() != n_stages:
        raise ValueError(f"{n_stages} stages need {n_stages} processes, got "
                         f"{dist.get_world_size()}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(init_device_mesh(device_type, (n_stages,), mesh_dim_names=(PIPE,)))


def shard_pipeline_params(stacked: dict, mesh: Mesh) -> dict:
    """This stage's contiguous L / n_stages layers of every stacked leaf."""
    n, s = mesh.shape[PIPE], mesh.rank(PIPE)
    out = {}
    for k, v in stacked.items():
        if v.shape[0] % n:
            raise ValueError(f"{v.shape[0]} layers do not divide over {n} stages")
        per = v.shape[0] // n
        out[k] = v.narrow(0, s * per, per).clone()
    return out


def _peer(mesh: Mesh, stage: int) -> int:
    return dist.get_global_rank(mesh.groups[PIPE], stage)


def _send(x: torch.Tensor, dst: int, tag: int) -> None:
    dist.send(x.contiguous().cpu() if dist.get_backend() == "gloo" else x.contiguous(), dst,
              tag=tag)


def _recv(shape, dtype, device, src: int, tag: int) -> torch.Tensor:
    host = dist.get_backend() == "gloo"
    buf = torch.empty(shape, dtype=dtype, device="cpu" if host else device)
    dist.recv(buf, src, tag=tag)
    return buf.to(device)


class _Send(torch.autograd.Function):
    """Send an activation to the next stage; the placeholder output's
    backward receives the activation's gradient from there."""

    @staticmethod
    def forward(ctx, x, dst, tag):
        _send(x, dst, tag)
        ctx.meta = (x.shape, x.dtype, x.device, dst, tag)
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        shape, dtype, device, dst, tag = ctx.meta
        return _recv(shape, dtype, device, dst, tag), None, None


class _Recv(torch.autograd.Function):
    """Receive an activation from the previous stage (``anchor`` only puts
    the node in the graph); backward sends its gradient back."""

    @staticmethod
    def forward(ctx, anchor, shape, dtype, src, tag):
        ctx.src, ctx.tag = src, tag
        return _recv(shape, dtype, anchor.device, src, tag)

    @staticmethod
    def backward(ctx, g):
        _send(g, ctx.src, ctx.tag)
        return None, None, None, None, None


def pipeline_text_forward(
    stacked: dict,
    cfg: TextConfig,
    inputs_embeds: torch.Tensor,  # (B, S, D), the same on every stage
    position_ids: torch.Tensor,  # (3, B, S) M-RoPE positions
    mesh: Mesh,
    *,
    n_microbatches: int,
    final_norm: Optional[torch.Tensor] = None,
    attn_impl: str = "auto",
) -> torch.Tensor:
    """Pipelined full-sequence decoder forward -> (B, S, D) hidden states,
    the same on every stage. ``stacked`` is this stage's layers
    (``shard_pipeline_params``); ``n_microbatches`` must divide the batch
    (the bubble is (n_stages - 1) / (M + n_stages - 1) of the steps).
    ``final_norm`` applies the final RMSNorm after."""
    n_stages, stage = mesh.shape[PIPE], mesh.rank(PIPE)
    B, S, D = inputs_embeds.shape
    M = n_microbatches
    assert B % M == 0, f"batch {B} not divisible by {M} microbatches"
    mb = B // M
    rope = mrope_cos_sin_interleaved if cfg.mrope_interleaved else mrope_cos_sin
    cos, sin = rope(position_ids, cfg.head_dim, cfg.mrope_section, cfg.rope_theta)
    cos, sin = cos.to(inputs_embeds.dtype), sin.to(inputs_embeds.dtype)
    seq_positions = torch.arange(S, device=inputs_embeds.device).expand(mb, S)
    n_local = next(iter(stacked.values())).shape[0]
    layers = [{k: v[i] for k, v in stacked.items()} for i in range(n_local)]
    embeds = mesh.copy_in(inputs_embeds, PIPE)

    def apply_layers(x, c, s_):
        for layer in layers:
            h = rms_norm(x, layer["input_norm"], cfg.rms_norm_eps)
            x = x + _attention_layer(layer, cfg, h, c, s_, seq_positions, None, None, 0, 0,
                                     attn_impl, False, "auto")
            h = rms_norm(x, layer["post_norm"], cfg.rms_norm_eps)
            x = x + _mlp(layer, cfg, h, attn_impl)
        return x

    anchor = embeds.new_zeros((), requires_grad=torch.is_grad_enabled())
    ties = [embeds.sum() * 0]  # every stage's graph reaches the inputs' copy_in
    outs = []
    for t in range(M + n_stages - 1):
        m = t - stage
        if not 0 <= m < M:
            continue  # the bubble
        rows = slice(m * mb, (m + 1) * mb)
        if stage == 0:
            x = embeds[rows]
        else:
            x = _Recv.apply(anchor, (mb, S, D), embeds.dtype, _peer(mesh, stage - 1), m)
        y = apply_layers(x, cos[rows], sin[rows])
        if stage < n_stages - 1:
            ties.append(_Send.apply(y, _peer(mesh, stage + 1), m))
        else:
            outs.append(y)
    mine = torch.cat(outs, 0) if outs else torch.zeros_like(embeds)
    hidden = mesh.all_reduce(mine + torch.stack(ties).sum() * 0, PIPE)
    if final_norm is not None:
        hidden = rms_norm(hidden, final_norm, cfg.rms_norm_eps)
    return hidden


def _sequential_text_forward(layers, cfg, embeds, position_ids, final_norm, attn_impl):
    from ..models.qwen25vl.text import text_forward

    hidden, _ = text_forward({"layers": layers, "final_norm": final_norm}, cfg, embeds,
                             position_ids, attn_impl=attn_impl)
    return hidden


def dryrun_pipeline_step(n_stages: int = 2, n_microbatches: int = 2, *, cfg=None,
                         device=None, seed: int = 2, batch_rows: Optional[int] = None,
                         seq_len: int = 12, check_sequential: bool = False):
    """One whole pipelined train step (forward, backward through the
    stages' sends, AdamW at lr 1e-5, optax's defaults) on a decoder over a
    ``pipe`` mesh of the initialized process group's ``n_stages`` ranks.
    ``cfg`` defaults to the tiny float32 config at 2 layers a stage; the
    weights are drawn from ``seed``. Returns the loss, or with
    ``check_sequential`` a dict: the loss, the same step's loss without the
    pipeline (every layer on this rank), and the largest difference of
    their hidden states and of each gradient, beside the sequential ones'
    largest magnitudes."""
    import dataclasses

    from ..models.qwen25vl import params as PM
    from ..models.qwen25vl.config import Qwen25VLConfig
    from ..models.qwen25vl.model import embed_tokens, get_rope_index
    from ..models.qwen25vl.text import logits_from_hidden

    device = torch.device(device or "cpu")
    if cfg is None:
        cfg = Qwen25VLConfig.tiny(dtype=torch.float32)
        cfg = dataclasses.replace(cfg, text=dataclasses.replace(
            cfg.text, num_hidden_layers=2 * n_stages))
    mesh = make_pipe_mesh(n_stages, device.type)
    params = PM.init(cfg, seed, device)
    rest = {k: v for k, v in params["text"].items() if k != "layers"}
    stacked = shard_pipeline_params(stack_pipeline_params(params["text"]["layers"]), mesh)
    trained = list(stacked.values()) + [rest["embed_tokens"], rest["final_norm"],
                                        rest["lm_head"]]
    for x in trained:
        x.requires_grad_(True)

    rng = np.random.default_rng(3)
    B, S = batch_rows or 2 * n_microbatches, seq_len
    ids_np = rng.integers(5, 99, size=(B, S))
    pos = torch.from_numpy(get_rope_index(cfg, ids_np)[0]).to(device)
    ids = torch.from_numpy(ids_np).to(device)
    labels = torch.roll(ids, -1, dims=-1)

    def loss_of(hidden):
        logp = torch.log_softmax(logits_from_hidden(rest, hidden), dim=-1)
        nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
        return nll[:, :-1].mean()

    embeds = embed_tokens({"text": rest}, ids)
    hidden = pipeline_text_forward(stacked, cfg.text, embeds, pos, mesh,
                                   n_microbatches=n_microbatches, final_norm=rest["final_norm"])
    loss = loss_of(hidden)
    loss.backward()
    grads = [x.grad.clone() for x in trained]
    out = {"loss": loss.item()}
    if check_sequential:
        whole = {k: v.detach().clone().requires_grad_(True)
                 for k, v in stack_pipeline_params(params["text"]["layers"]).items()}
        flat = [rest["embed_tokens"], rest["final_norm"], rest["lm_head"]]
        for x in flat:
            x.grad = None
        ref = _sequential_text_forward(unstack_pipeline_params(whole), cfg.text,
                                       embed_tokens({"text": rest}, ids), pos,
                                       rest["final_norm"], "auto")
        ref_loss = loss_of(ref)
        ref_loss.backward()
        per = next(iter(whole.values())).shape[0] // n_stages
        s0 = mesh.rank(PIPE) * per
        ref_grads = [whole[k].grad[s0:s0 + per] for k in stacked] + [x.grad for x in flat]
        out.update(
            sequential_loss=ref_loss.item(),
            hidden_err=float((hidden.detach().float() - ref.detach().float()).abs().max()),
            hidden_scale=float(ref.detach().float().abs().max()),
            grad_err=max(float((a.float() - b.float()).abs().max())
                         for a, b in zip(grads, ref_grads)),
            grad_scale=max(float(b.float().abs().max()) for b in ref_grads))
        for x in flat:
            x.grad = None
        for x, g in zip(trained, grads):
            x.grad = g
    opt = torch.optim.AdamW(trained, lr=1e-5, eps=1e-8, weight_decay=1e-4)
    opt.step()
    return out if check_sequential else out["loss"]
