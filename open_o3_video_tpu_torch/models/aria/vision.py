"""Aria's vision tower (Idefics3/SigLIP ViT) and cross-attention projector
(counterpart of ``open_o3_video_tpu/models/aria/vision.py``).

HF ``Idefics3VisionTransformer`` (a patch embedding, a learned position
embedding, pre-LN bidirectional blocks) feeding HF ``AriaProjector`` (a
learned query bank, cross-attention over the patch states, an MLP into the
text embedding space). Images are fixed-size squares, so every shape is
static. Attention is the JAX package's plain form: a product of q and k in
the activations' dtype, a float32 softmax, a product with v; at 4900
patches and 16 heads the float32 scores are ~1.5 GB an image.

Under a full fine-tune the tower and projector train with no per-block
remat, as in the JAX package, so each block keeps its float32 softmax for
the backward; under PEFT no leaf of either requires a gradient, and
autograd records nothing of them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...ops.quant import dense
from ...ops.sharded import local
from ..qwen25vl.vision import layer_norm
from .config import AriaConfig, AriaVisionConfig


def patchify_images(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, C, H, W) images -> (B, n_patches, C * ps * ps) patch rows, patches
    row-major and each channel-major, the layout of the flattened
    Conv2d(kernel = stride = ps) weight."""
    B, C, H, W = images.shape
    gh, gw = H // patch_size, W // patch_size
    x = images.reshape(B, C, gh, patch_size, gw, patch_size).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(B, gh * gw, C * patch_size * patch_size)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Dense bidirectional multi-head attention over (B, S, D) q, k, v."""
    B, _, D = q.shape
    hd = D // num_heads

    def split(x):
        return x.reshape(B, -1, num_heads, hd).transpose(1, 2)

    q, k, v = split(q), split(k), split(v)
    scores = (q @ k.transpose(-1, -2)) * hd**-0.5
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return (probs @ v).transpose(1, 2).reshape(B, -1, D)


def position_ids(cfg: AriaVisionConfig, gh: int, gw: int, device) -> torch.Tensor:
    """The learned position embedding's row per patch: fractional
    coordinates bucketised onto the num_patches_per_side grid, as
    transformers 4.57's ``Idefics3VisionEmbeddings`` computes them
    (``i / g * (1 - 1e-6)``; later revisions bucketise ``arange(0, 1 - 1e-6,
    1 / g)``, which differs, e.g. at g = 2)."""
    nps = cfg.num_patches_per_side
    frac_h = torch.arange(gh, device=device) / gh * (1 - 1e-6)
    frac_w = torch.arange(gw, device=device) / gw * (1 - 1e-6)
    bucket_h = torch.floor(frac_h * nps).long()
    bucket_w = torch.floor(frac_w * nps).long()
    return (bucket_h[:, None] * nps + bucket_w[None, :]).reshape(-1)


def vision_tower(params: dict, cfg: AriaVisionConfig, images: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> the last encoder layer's hidden states (B, n_patches,
    D), before the tower's post-layernorm (HF ``vision_feature_layer=-1``)."""
    ps = cfg.patch_size
    _, _, H, W = images.shape
    x = dense(patchify_images(images, ps), params["patch_embed"]) + params["patch_embed_b"]
    x = x + local(params["pos_embed"])[position_ids(cfg, H // ps, W // ps, images.device)]
    for blk in params["blocks"]:
        h = layer_norm(x, blk["norm1"], blk["norm1_b"], cfg.layer_norm_eps)
        attn = _attention(h @ blk["q_w"] + blk["q_b"], h @ blk["k_w"] + blk["k_b"],
                          h @ blk["v_w"] + blk["v_b"], cfg.num_attention_heads)
        x = x + (attn @ blk["out_w"] + blk["out_b"])
        h = layer_norm(x, blk["norm2"], blk["norm2_b"], cfg.layer_norm_eps)
        h = F.gelu(dense(h, blk["fc1_w"]) + blk["fc1_b"], approximate="tanh")
        x = x + (dense(h, blk["fc2_w"]) + blk["fc2_b"])
    return x


# The projector's norms are plain nn.LayerNorm: torch's default eps (the
# tower's take the config's layer_norm_eps).
PROJECTOR_LN_EPS = 1e-5


def projector(params: dict, cfg: AriaConfig, patch_states: torch.Tensor) -> torch.Tensor:
    """(B, n_patches, Dv) -> (B, query_num, Dt) image features in the text
    space (HF ``AriaProjector``): the learned queries and the patch states
    through their q/k/v projections, then a whole ``nn.MultiheadAttention``
    with its own in and out projections on top (a quirk of the published
    architecture, kept), a linear, a LayerNorm and a gelu-tanh MLP."""
    p = params["projector"]
    B, n_patches, Dv = patch_states.shape
    q_num = cfg.query_num(n_patches)
    queries = p["query"][:q_num].expand(B, q_num, Dv)
    q = layer_norm(queries, p["ln_q"], p["ln_q_b"], PROJECTOR_LN_EPS) @ p["q_w"]
    kv = layer_norm(patch_states, p["ln_kv"], p["ln_kv_b"], PROJECTOR_LN_EPS)
    k, v = kv @ p["k_w"], kv @ p["v_w"]
    attn = _attention(q @ p["mha_q_w"] + p["mha_q_b"], k @ p["mha_k_w"] + p["mha_k_b"],
                      v @ p["mha_v_w"] + p["mha_v_b"], cfg.vision.num_attention_heads)
    attn = attn @ p["mha_out_w"] + p["mha_out_b"]
    attn = attn @ p["lin_w"] + p["lin_b"]
    h = layer_norm(attn, p["ln_ff"], p["ln_ff_b"], PROJECTOR_LN_EPS)
    return F.gelu(h @ p["ff_in_w"], approximate="tanh") @ p["ff_out_w"]
