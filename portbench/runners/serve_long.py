"""The long-context runner (``longctx1``): one 64-frame video request a
call, ~81k tokens, through the port's engine with an fp8 cache and its
chunked prefill, checked against the Qwen reference (``serve_check``).
Every piece but the program is the Qwen cells', so a commit before this
runner's runs it too."""

from __future__ import annotations

import functools

from portbench.lib import serve_check, session, traffic, work
from portbench.lib.arch import read_arch
from portbench.lib.video_serve import VideoServeProgram, frame_block_requests
from portbench.lib.weights import make_weights

# The reference's 81920-token contract less the 64 new tokens.
MAX_PROMPT = 81856


def check_call(call: dict, arch) -> None:
    for r in call["requests"]:
        if len(r["ids"]) > MAX_PROMPT:
            raise ValueError(f"a prompt of {len(r['ids'])} tokens exceeds {MAX_PROMPT}")


PIECES = session.Pieces(read_arch=read_arch, make_weights=make_weights,
                        program=functools.partial(VideoServeProgram,
                                                  requests=frame_block_requests),
                        make_call=traffic.make_call,
                        call_work=work.call_work, check=serve_check.check,
                        check_call=check_call)


def run(workload: str, files: dict, metrics: list, seed: int, seconds: float, trace: bool,
        device, t_start: float, judge: str | None = None) -> dict:
    return session.run(PIECES, workload, files, metrics, seed, seconds, trace, device, t_start,
                       judge)
