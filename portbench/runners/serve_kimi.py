"""The Kimi-VL session runner (``longvideo8``): one video a call and its
questions through the port's engine over the Kimi-VL family, checked
against ``reference/kimi_vl.py``. A program without the family (a commit
before it) fails at once, before any weight is made."""

from __future__ import annotations

import functools

from portbench.lib import kimi_arch, kimi_check, kimi_traffic, kimi_weights, kimi_work, session
from portbench.lib.video_serve import VideoServeProgram, session_requests

PIECES = session.Pieces(read_arch=kimi_arch.read_arch, make_weights=kimi_weights.make_weights,
                        program=functools.partial(VideoServeProgram, requests=session_requests),
                        make_call=kimi_traffic.make_call,
                        call_work=kimi_work.call_work, check=kimi_check.check)


def run(workload: str, files: dict, metrics: list, seed: int, seconds: float, trace: bool,
        device, t_start: float, judge: str | None = None) -> dict:
    import open_o3_video_tpu_torch.models.kimi_vl  # noqa: F401  (the family, or fail now)

    return session.run(PIECES, workload, files, metrics, seed, seconds, trace, device, t_start,
                       judge)
