"""Whether the served Kimi-VL tokens are right: the plain float32
reference (``reference/kimi_vl.py``) over a sample of the answers drawn
from the seed once the window has closed, as ``serve_check.check`` holds
the Qwen cells. For each sampled request the reference resizes the call's
frames again (Pillow's bicubic, ``reference/inputs.resize``), patchifies
them, runs the tower once per video and the decoder once over the prompt
and the served tokens; the served tokens' logits then come from the
program's prefix block (the video prefix), its suffix admission (the first
token) and its decode steps through the latent cache (the rest), each
against the reference's full forward. The numbers are ``serve_check``'s:
``gap_max``, ``off_share`` and beside them ``lp_err_max``, ``lp_err_mean``,
``gap_mean``, ``off_best``."""

from __future__ import annotations

import torch

from ..reference import inputs as ref_inputs
from ..reference import kimi_vl, qwen_vl
from .kimi_weights import make_weights
from .serve_check import OFF, gaps, penalized, sample


def check(arch, mix: dict, seed: int, calls: list, records: list, device,
          judge: str | None = None) -> dict:
    picked = sample(calls, records, seed, mix["check_requests"])
    weights = make_weights(arch, seed, device)
    towers: dict = {}
    gap, lp_err = [], []
    with torch.no_grad(), kimi_vl.full_float32():
        for c, r in picked:
            call = calls[c]
            ids = list(call["requests"][r]["ids"])
            served = records[c]["tokens"][r]
            seq, at = ids + served[:-1], slice(len(ids) - 1, len(ids) - 1 + len(served))
            if c not in towers:
                frames = torch.from_numpy(call["frames"]).to(device)
                rows = kimi_vl.patch_rows(ref_inputs.resize(frames, *call["resize_hw"]), arch)
                towers[c] = (rows, kimi_vl.vision_tower(weights["visual"], arch, rows,
                                                        [call["grid"]]))
            rows, tower = towers[c]
            z = kimi_vl.logits(weights, arch, seq, tower, at)
            zp = penalized(z, ids, served, mix["repetition_penalty"])
            tokens = torch.as_tensor(served, device=z.device)
            lp_ref = torch.log_softmax(z, -1).gather(1, tokens[:, None])[:, 0]
            lp = torch.as_tensor(records[c]["logprobs"][r], device=z.device, dtype=torch.float32)
            if judge == "fp8":
                mm = qwen_vl.fp8_matmul
                tc = kimi_vl.vision_tower(weights["visual"], arch, rows, [call["grid"]], mm)
                zc = kimi_vl.logits(weights, arch, seq, tc, at, mm)
                lp = torch.log_softmax(zc, -1).gather(1, tokens[:, None])[:, 0]
                tokens = penalized(zc, ids, served, mix["repetition_penalty"]).argmax(1)
            gap.append(gaps(zp, tokens))
            lp_err.append((lp - lp_ref).abs())
    g, e = torch.cat(gap), torch.cat(lp_err)
    return {"gap_max": float(g.max()),
            "off_share": float(((g > OFF) | (e > OFF)).float().mean()),
            "lp_err_max": float(e.max()), "lp_err_mean": float(e.mean()),
            "gap_mean": float(g.mean()), "off_best": float((g > 0).float().mean()),
            "tokens": int(g.numel()), "requests": len(picked),
            "picked": [[int(c), int(r)] for c, r in picked], "judge": judge}
