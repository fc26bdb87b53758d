"""Whether the served tokens are right: the plain float32 reference over a
sample of the answers, drawn from the seed once the window has closed.

For each sampled request the reference works out its prompt text, token
ids, resized frames, patch rows and M-RoPE positions again from the raw
inputs, runs the tower once per video and the decoder once over the prompt
and the served tokens, and reads, at each served token, the gap by which
its logit lies below the reference's best after the repetition penalty of
the mix (greedy decoding picks the best), and the distance between the
log-probability the program reported for it and the reference's. A cell's
limits file says which numbers it compares (``check``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import inputs as ref_inputs
from ..reference import qwen_vl
from . import vstar_prompts
from .weights import make_weights

# V-STAR's queries whose prompts share the video prefix (the prefix cache's
# members) and those whose prompts differ before it (plain admissions).
VSTAR_PREFIX_KEYS = ("vqa", "spatial", "spatial_2")
VSTAR_SYSTEM = "You are a helpful assistant."
# A served token is off where its gap below the reference's best, or the
# distance of its reported log-probability from the reference's, exceeds
# this: about three times the per-token rms of that distance in the bf16
# program (0.015-0.019 on the 30B at its cell's size, on an H100), under the float8
# control's (0.041-0.073).
OFF = 0.05


def vstar_text(call: dict, key: str) -> str:
    """The eval's prompt text of query ``key`` of a V-STAR call."""
    p = call["prompts"][key]
    fp = vstar_prompts.frame_prompt(call["times"])
    p = p.replace(vstar_prompts.VIDEO_BLOCK, fp) if vstar_prompts.VIDEO_BLOCK in p else fp + p
    text = ref_inputs.render_chat([
        {"role": "system", "content": VSTAR_SYSTEM},
        {"role": "user", "content": [{"type": "text", "text": p}]
         + [{"type": "image"} for _ in call["frames"]]}])
    return vstar_prompts.strip_stray_vision_tags(text)


def request_inputs(call: dict, r: int, arch, device) -> dict:
    """Token ids, the rope grids, the tower's patches and grid of request
    ``r`` of ``call``, worked out from the raw inputs."""
    v = arch.vision
    if call["entry"] == "vstar_item":
        h, w = call["frames"][0].shape[:2]
        rh, rw = ref_inputs.smart_resize(h, w, factor=v.patch * v.merge)
        frames = torch.from_numpy(np.stack(call["frames"])).to(device).permute(0, 3, 1, 2)
        rows = ref_inputs.patch_rows(ref_inputs.resize(frames, rh, rw), v.patch,
                                     v.temporal_patch, v.merge)
        grids = [(1, rh // v.patch, rw // v.patch)] * len(call["frames"])
        counts = [gh * gw // v.unit for _, gh, gw in grids]
        text = ref_inputs.expand_pads(vstar_text(call, call["keys"][r]), ref_inputs.IMAGE_PAD,
                                      counts)
        return {"video": id(call["frames"]), "ids": ref_inputs.encode(text), "rope_grids": grids,
                "patches": rows, "tower_grid": grids}
    req = call["requests"][r]
    t, gh, gw = req["grid"]
    frames = torch.from_numpy(req["frames"]).to(device)
    rows = ref_inputs.patch_rows(ref_inputs.resize(frames, *req["resize_hw"]), v.patch,
                                 v.temporal_patch, v.merge)
    return {"video": id(req["frames"]), "ids": list(req["ids"]), "rope_grids": [(1, gh, gw)] * t,
            "patches": rows, "tower_grid": [(t, gh, gw)]}


def sample(calls: list, records: list, seed: int, n: int) -> list:
    """(call index, request index) pairs drawn from the seed among the
    finished answers: the longest answer first (ties drawn), then, for
    V-STAR, the longest of the other kind of query (prefix member or plain),
    else drawn at random."""
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 7])
    pairs = [(c, r) for c, rec in enumerate(records) for r in range(len(rec["tokens"]))]
    lens = np.array([len(records[c]["tokens"][r]) for c, r in pairs])
    order = rng.permutation(len(pairs))
    first = max(order, key=lambda i: lens[i])
    picked = [pairs[first]]
    c0, r0 = pairs[first]
    if calls[c0]["entry"] == "vstar_item":
        kind0 = calls[c0]["keys"][r0] in VSTAR_PREFIX_KEYS
        other = [i for i in order
                 if (calls[pairs[i][0]]["keys"][pairs[i][1]] in VSTAR_PREFIX_KEYS) != kind0]
        if other:
            picked.append(pairs[max(other, key=lambda i: lens[i])])
    rest = [i for i in order if pairs[i] not in picked]
    picked += [pairs[i] for i in rest[:max(n - len(picked), 0)]]
    return picked[:n]


def penalized(z: torch.Tensor, prompt: list, served: list, penalty: float) -> torch.Tensor:
    """Logits (n, V) at the served positions after the repetition penalty
    over the prompt and the tokens served before each position."""
    n, V = z.shape
    seen = torch.zeros(n, V, dtype=torch.bool, device=z.device)
    seen[:, torch.as_tensor(prompt, device=z.device)] = True
    tok = torch.as_tensor(served, device=z.device)
    for i in range(n - 1):
        seen[i + 1:, tok[i]] = True
    return torch.where(seen, torch.where(z > 0, z / penalty, z * penalty), z)


def gaps(zp: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Per position: the best penalized logit less that of ``tokens``."""
    return zp.max(dim=1).values - zp.gather(1, tokens[:, None])[:, 0]


def check(arch, mix: dict, seed: int, calls: list, records: list, device,
          judge: str | None = None) -> dict:
    """The numbers compared over the sampled answers, and what was compared:
    ``gap_max``, the widest gap of a served token below the reference's best
    (after the mix's repetition penalty); ``off_share``, the share of served
    tokens that are off: whose gap, or whose distance between the
    log-probability the program reported for it (under the raw logits) and
    the reference's, is over ``OFF``; beside them ``lp_err_max`` and
    ``lp_err_mean``, the widest and the mean of that distance, ``gap_mean``
    and ``off_best`` (the share of tokens not the reference's best).

    ``judge`` "fp8" puts the check's control in the program's place: the
    reference again with every product of the tower, the layers and the
    lm_head in float8 e4m3 (``qwen_vl.fp8_matmul``) over the same prompts
    and served tokens, its own first token at each position and its
    log-probability of each served token."""
    picked = sample(calls, records, seed, mix["check_requests"])
    weights = make_weights(arch, seed, device)
    towers: dict = {}
    gap, lp_err = [], []
    with torch.no_grad(), qwen_vl.full_float32():
        for c, r in picked:
            inp = request_inputs(calls[c], r, arch, device)
            served = records[c]["tokens"][r]
            seq, at = inp["ids"] + served[:-1], slice(len(inp["ids"]) - 1,
                                                      len(inp["ids"]) - 1 + len(served))
            key = inp["video"]
            if key not in towers:
                towers[key] = qwen_vl.vision_tower(weights["visual"], arch, inp["patches"],
                                                   inp["tower_grid"])
            z = qwen_vl.logits(weights, arch, seq, inp["rope_grids"], towers[key], at)
            zp = penalized(z, inp["ids"], served, mix["repetition_penalty"])
            tokens = torch.as_tensor(served, device=z.device)
            lp_ref = torch.log_softmax(z, -1).gather(1, tokens[:, None])[:, 0]
            lp = torch.as_tensor(records[c]["logprobs"][r], device=z.device, dtype=torch.float32)
            if judge == "fp8":
                mm = qwen_vl.fp8_matmul
                tower = qwen_vl.vision_tower(weights["visual"], arch, inp["patches"],
                                             inp["tower_grid"], mm)
                zc = qwen_vl.logits(weights, arch, seq, inp["rope_grids"], tower, at, mm)
                lp = torch.log_softmax(zc, -1).gather(1, tokens[:, None])[:, 0]
                tokens = penalized(zc, inp["ids"], served, mix["repetition_penalty"]).argmax(1)
            gap.append(gaps(zp, tokens))
            lp_err.append((lp - lp_ref).abs())
    g, e = torch.cat(gap), torch.cat(lp_err)
    return {"gap_max": float(g.max()),
            "off_share": float(((g > OFF) | (e > OFF)).float().mean()),
            "lp_err_max": float(e.max()),
            "lp_err_mean": float(e.mean()), "gap_mean": float(g.mean()),
            "off_best": float((g > 0).float().mean()),
            "tokens": int(g.numel()), "requests": len(picked),
            "picked": [[int(c), int(r)] for c, r in picked], "judge": judge}
