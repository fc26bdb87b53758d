"""RMSNorm (``ops/rms_norm.py``, kernel ``csrc/rms_norm.cu``): on the CPU
the dispatch rule, the plain version against the formula, the row layouts
and the kernel's launch plan, every decoder's norm sites with their
``impl``, and the kernel's count in a whole ``generate``; on the card (``python -m pytest --noconftest -m cuda
tests/test_torch_rms_norm.py``) the kernel against its plain version at the
port's widths, and a captured decode step of each decoder family."""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import cuda_device, frames, rng

from open_o3_video_tpu_torch.data.processor import ByteTokenizer, O3VideoProcessor
from open_o3_video_tpu_torch.engine import InferenceEngine, Request, SamplingParams
from open_o3_video_tpu_torch.engine import engine as engine_module
from open_o3_video_tpu_torch.models import kimi_vl as K
from open_o3_video_tpu_torch.models.qwen25vl import Qwen25VLConfig
from open_o3_video_tpu_torch.models.qwen25vl import config as TC
from open_o3_video_tpu_torch.models.qwen25vl import params as TP
from open_o3_video_tpu_torch.models.qwen25vl import text as TT
from open_o3_video_tpu_torch.models.qwen25vl import vision as TV
from open_o3_video_tpu_torch.ops import kernels
from open_o3_video_tpu_torch.ops import rms_norm as N

BF16 = torch.bfloat16


def _formula(x, w, eps):
    """The decoders' norm as it was written before the kernel."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (xf * w.float()).to(x.dtype)


def _x(*shape, dtype=BF16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).to(dtype)


def _w(d, dtype=BF16, seed=1):
    g = torch.Generator().manual_seed(seed)
    return (1 + 0.1 * torch.randn(d, generator=g)).to(dtype)


@pytest.mark.parametrize("x_dtype,w_dtype", [(BF16, BF16), (BF16, torch.float32),
                                             (torch.float32, torch.float32)])
@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_plain_version_is_the_formula_bit_for_bit(x_dtype, w_dtype, eps):
    x, w = _x(3, 5, 64, dtype=x_dtype), _w(64, w_dtype)
    want = _formula(x, w, eps)
    assert torch.equal(N.rms_norm_torch(x, w, eps), want)
    assert torch.equal(N.rms_norm(x, w, eps), want)  # the CPU keeps it


def _kimi_view():
    return _x(2, 3, 576)[..., :512]  # ckv[..., :R]: rows 576 apart


def _misaligned():
    return _x(2, 3, 72)[..., 4:68]  # rows 144 bytes apart, the first 8 bytes in


def _uneven():
    return _x(4, 6, 64)[:, :3]  # rows of a batch row 64 apart, batch rows 384


# (x, weight, context, impl, card: use_kernel patched to say "on the card",
# expect: the kernel runs)
DISPATCH_CASES = {
    "bf16 rows under inference mode": (lambda: _x(2, 3, 64), _w(64), "inference", "auto", True,
                                       True),
    "Kimi's strided latent view": (_kimi_view, _w(512), "inference", "auto", True, True),
    "a float32 weight": (lambda: _x(8, 128), _w(128, torch.float32), "inference", "auto", True,
                         True),
    "no_grad alone": (lambda: _x(2, 3, 64), _w(64), "no_grad", "auto", True, False),
    "autograd": (lambda: _x(2, 3, 64).requires_grad_(), _w(64), "grad", "auto", True, False),
    "float32 x": (lambda: _x(2, 3, 64, dtype=torch.float32), _w(64, torch.float32),
                  "inference", "auto", True, False),
    "impl torch": (lambda: _x(2, 3, 64), _w(64), "inference", "torch", True, False),
    "width not a multiple of 8": (lambda: _x(2, 3, 60), _w(60), "inference", "auto", True, False),
    "rows off 16 bytes": (_misaligned, _w(64), "inference", "auto", True, False),
    "rows not evenly spaced": (_uneven, _w(64), "inference", "auto", True, False),
    "a float16 weight": (lambda: _x(2, 3, 64), _w(64, torch.float16), "inference", "auto", True,
                         False),
    "on the CPU": (lambda: _x(2, 3, 64), _w(64), "inference", "auto", False, False),
}


def _context(name):
    return {"inference": torch.inference_mode(), "no_grad": torch.no_grad(),
            "grad": contextlib.nullcontext()}[name]


@pytest.mark.parametrize("case", list(DISPATCH_CASES))
def test_the_kernel_runs_exactly_where_the_rule_holds(monkeypatch, case):
    """``kernels.use_kernel`` patched to answer as on the card and a spy on
    the wrapper: the wrapper is called exactly where the rule holds, and
    every path returns the formula's bits."""
    make_x, w, ctx, impl, card, expect = DISPATCH_CASES[case]
    if card:
        monkeypatch.setattr(kernels, "use_kernel", lambda x, impl: impl != "torch")
    calls = []

    def spy(x, weight, eps):
        calls.append((tuple(x.shape), N.row_stride(x), weight.dtype, eps))
        return N.rms_norm_torch(x, weight, eps)

    monkeypatch.setattr(N, "rms_norm_kernel", spy)
    x = make_x()
    with _context(ctx):
        out = N.rms_norm(x, w, 1e-5, impl)
    assert len(calls) == int(expect)
    if case == "Kimi's strided latent view":
        assert calls[0][1] == 576
    assert torch.equal(out.detach(), _formula(x.detach(), w, 1e-5))


@pytest.mark.parametrize("make_x,stride", [
    (lambda: torch.zeros(64), 64),
    (lambda: torch.zeros(1, 1, 64), 64),
    (lambda: torch.zeros(8, 1, 32, 128), 128),
    (lambda: torch.zeros(2, 3, 576)[..., :512], 576),
    (lambda: torch.zeros(5, 576)[:, 64:], 576),
    (lambda: torch.zeros(4, 6, 64)[:, :3], None),
    (lambda: torch.zeros(64, 8).t(), None),
    (lambda: torch.zeros(3, 1)[:, :1].expand(3, 8), None),
])
def test_row_stride(make_x, stride):
    assert N.row_stride(make_x()) == stride


WIDTHS = (8, 40, 128, 512, 1280, 2048, 2560, 3584, 8192, N.MAX_WIDTH)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("rows", [1, 8, 256, 16384, 317952])
def test_launch_plan_covers_every_row_and_chunk(d, rows):
    """Threads a CTA a whole number of warps, at most 1024; the group holds
    every 16-byte chunk of a row at MAX_CHUNKS a thread and is the least
    power of two that does; rows spread over the SMs before they share a
    CTA; at most a full card's worth of CTAs."""
    sms = 132
    log2, per_cta, grid = N.plan(rows, d, sms)
    tpr, chunks = 1 << log2, d // N.CHUNK
    threads = tpr * per_cta
    assert threads % 32 == 0 and threads <= 1024 and grid >= 1
    assert tpr * N.MAX_CHUNKS >= chunks and (tpr == 1 or (tpr // 2) * N.MAX_CHUNKS < chunks)
    assert grid <= -(-rows // per_cta) and grid <= sms * max(1, 2048 // threads)
    if rows <= sms:
        assert per_cta == max(1, 32 // tpr)


def test_entry_point_matches_its_source():
    """The C entry point's parameters match the ctypes signature, and the
    chunks a thread holds are the same number on both sides."""
    src = (Path(kernels.SOURCE_DIR) / "rms_norm.cu").read_text()
    params = re.search(r'extern "C" int o3v_rms_norm\(([^)]*)\)', src).group(1).split(",")
    assert len(params) == len(kernels._SIGNATURES["o3v_rms_norm"])
    assert f"constexpr int kMaxChunks = {N.MAX_CHUNKS};" in src


def _qwen25():
    cfg = Qwen25VLConfig.tiny(BF16)
    return cfg, TP.init(cfg, 0, "cpu"), 2


def _qwen3_moe():
    cfg = TC.tiny_qwen3_moe(BF16)
    return cfg, TP.init(cfg, 0, "cpu"), 4


def _kimi():
    cfg = K.tiny_kimi_vl(BF16)
    return cfg, K.params.init(cfg, 0, "cpu"), 3


FAMILIES = {"qwen2.5-vl": (_qwen25, TT.text_forward),
            "qwen3-vl-moe": (_qwen3_moe, TT.text_forward),
            "kimi-vl": (_kimi, K.text_forward)}


@pytest.fixture
def asked(monkeypatch):
    """The ``impl`` of each call of the rule, which still decides."""
    seen, real = [], N.kernel_takes

    def rule(x, weight, impl):
        seen.append(impl)
        return real(x, weight, impl)

    monkeypatch.setattr(N, "kernel_takes", rule)
    return seen


@pytest.mark.parametrize("impl", ["auto", "torch"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_every_norm_site_of_a_decoder_passes_its_impl(asked, family, impl):
    """A decoder forward under inference mode asks the rule once for each
    norm site (per layer 2 for Qwen2.5, 4 for Qwen3-MoE with its q/k norms,
    3 for Kimi with its latent norm; and the final norm), each with the
    forward's ``attn_impl``; the rule says no here (the CPU)."""
    make, forward = FAMILIES[family]
    cfg, params, sites = make()
    t = cfg.text
    B, S = 2, 5
    emb = _x(B, S, t.hidden_size)
    pos = torch.arange(S)[None, None].expand(3, B, S)
    with torch.inference_mode():
        forward(params["text"], t, emb, pos, attn_impl=impl)
    assert asked == [impl] * (sites * t.num_hidden_layers + 1)


@pytest.mark.parametrize("impl", ["auto", "torch"])
def test_the_qwen25_tower_norms_pass_its_impl(asked, impl):
    """Qwen2.5-VL's tower: two norms a block and the merger's, each with
    the tower's ``impl``."""
    cfg = Qwen25VLConfig.tiny(BF16)
    params = TP.init(cfg, 0, "cpu")
    v = cfg.vision
    grid = [(2, 8, 8)]
    spec = TV.compute_vision_spec(grid, v)
    patches = _x(2 * 8 * 8, v.in_channels * v.temporal_patch_size * v.patch_size ** 2)
    with torch.inference_mode():
        TV.vision_forward(params["visual"], patches, spec, v, impl=impl)
    assert asked == [impl] * (2 * v.depth + 1)


def _ids(seed, *lens):
    r = np.random.default_rng(seed)
    return [r.integers(5, 90, size=n).tolist() for n in lens]


def _image_request(cfg):
    proc = O3VideoProcessor(tokenizer=ByteTokenizer.for_config(cfg))
    body = "".join(f"Frame {i + 1}: <|vision_start|><|image_pad|><|vision_end|>\n"
                   for i in range(2))
    x = proc(f"<|im_start|>user\n{body}Where is the ball?<|im_end|>\n<|im_start|>assistant\n",
             images=list(frames(rng(5), 2, 56, 84)))
    return Request(x.input_ids, x.pixel_patches, x.grid_thw, cfg.image_token_id)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_generate_runs_the_kernel_at_every_norm_site_of_every_forward(monkeypatch, family):
    """``InferenceEngine.generate`` with the rule answering as on the card
    (the device aside) and a spy on the kernel: two plain prompts, three
    sharing a prefix (a prefix block and suffix admissions) and, for
    Qwen2.5-VL, an image request through its RMSNorm tower. The kernel runs
    once a norm site in every prefill forward and every decode step, and
    2 x blocks + 1 times a Qwen2.5-VL tower pass (none in the LayerNorm
    towers): the count ``chip_smoke.py``'s ``norm_launches`` holds the
    card's runs to."""
    make, _ = FAMILIES[family]
    cfg, params, sites = make()
    calls = []

    def kernel(x, weight, eps):
        calls.append(x.shape[-1])
        return N.rms_norm_torch(x, weight, eps)

    monkeypatch.setattr(N, "kernel_takes", lambda x, weight, impl: (
        impl != "torch" and torch.is_inference_mode_enabled() and N.supported(x, weight)))
    monkeypatch.setattr(N, "rms_norm_kernel", kernel)
    shared = _ids(2, 24)[0]
    reqs = [Request(x) for x in _ids(1, 20, 9)] + [Request(shared + t) for t in _ids(3, 3, 5, 2)]
    tower = 0
    if family == "qwen2.5-vl":
        reqs.append(_image_request(cfg))
        tower = 2 * cfg.vision.depth + 1
    engine = InferenceEngine(params, cfg, max_slots=2, prompt_buckets=(32, 64, 128),
                             prefix_cache_min=8, suffix_buckets=(16,))
    engine.generate(reqs, SamplingParams(temperature=0.0, repetition_penalty=1.05, max_tokens=6))
    c = engine.counters
    ran = engine.decode_steps + engine.decode_steps_wasted
    assert c["prefix_blocks"] == 1 and c["tower_passes"] == (1 if tower else 0) and ran > 0
    forward = sites * cfg.text.num_hidden_layers + 1
    assert len(calls) == forward * (c["prefills"] + ran) + tower * c["tower_passes"]


# ---------------------------------------------------------------- the card

CARD_WIDTHS = (128, 512, 1280, 2048, 2560, 3584, 8192)
CARD_ROWS = (1, 8, 256, 300_000)
COMPARE_ROWS = 32768  # the plain version in slices of rows (its float32 temporaries)


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 ulps between a and b elementwise (ordered bit patterns, so that
    +0 and -0 are one value)."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (ordered(a) - ordered(b)).abs()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", CARD_ROWS)
@pytest.mark.parametrize("d", CARD_WIDTHS)
def test_kernel_matches_its_plain_version_within_one_ulp(d, rows):
    """Every width the port normalises (Qwen3's q/k heads, Kimi's latent,
    Qwen2.5-VL's tower, the 30B and Kimi, Aria, the 7B, the 72B judge) at 1,
    8, 256 and 300k rows, eps 1e-6 and 1e-5, bf16 and float32 weights,
    contiguous and strided rows (64 values of padding between rows): each
    output equals the plain version's or lies one bf16 ulp from it, and no
    NaN appears where the plain version has none. Rows of several scales,
    one of zeros and one of large values."""
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(d + rows)
    buf = torch.empty(rows, d + 64, device=dev, dtype=BF16)
    scale = torch.exp(2 * torch.randn(rows, 1, device=dev, generator=g))
    buf[:, :d] = (torch.randn(rows, d, device=dev, generator=g) * scale).to(BF16)
    buf[0, :d] = 0
    if rows > 1:
        buf[1, :d] = 300.0 * torch.sign(buf[1, :d])
    for strided in (False, True):
        x = buf[:, :d] if strided else buf[:, :d].contiguous()
        for w_dtype in (BF16, torch.float32):
            w = (1 + 0.3 * torch.randn(d, device=dev, generator=g)).to(w_dtype)
            for eps in (1e-6, 1e-5):
                before = kernels.LAUNCHES["rms_norm"]
                with torch.inference_mode():
                    out = N.rms_norm(x, w, eps)
                assert kernels.LAUNCHES["rms_norm"] == before + 1
                for r0 in range(0, rows, COMPARE_ROWS):
                    got, ref = out[r0:r0 + COMPARE_ROWS], N.rms_norm_torch(
                        x[r0:r0 + COMPARE_ROWS], w, eps)
                    assert not (got.isnan() & ~ref.isnan()).any()
                    worst = _ulps(got, ref).max().item()
                    assert worst <= 1, (strided, w_dtype, eps, r0, worst)
                del out
    torch.cuda.empty_cache()


def _card_family(name):
    """The tiny configs in bf16 with the widths the card's attention kernels
    are built for (head_dim 128; Kimi's latent 512 + 64, heads 128 + 64 /
    128), and the norm sites of a layer."""
    if name == "qwen2.5-vl":
        cfg = Qwen25VLConfig.tiny(BF16)
        text = dataclasses.replace(cfg.text, hidden_size=256, intermediate_size=512,
                                   num_attention_heads=2, num_key_value_heads=1,
                                   mrope_section=(16, 24, 24))
        cfg = dataclasses.replace(cfg, text=text)
        return cfg, TP.init(cfg, 0, "cuda"), 2
    if name == "qwen3-vl-moe":
        cfg = TC.tiny_qwen3_moe(BF16)
        text = dataclasses.replace(cfg.text, explicit_head_dim=128, num_attention_heads=2,
                                   num_key_value_heads=1, mrope_section=(24, 20, 20))
        cfg = dataclasses.replace(cfg, text=text)
        return cfg, TP.init(cfg, 0, "cuda"), 4
    cfg = K.tiny_kimi_vl(BF16)
    text = dataclasses.replace(cfg.text, kv_lora_rank=512, qk_rope_head_dim=64,
                               qk_nope_head_dim=128, v_head_dim=128)
    cfg = dataclasses.replace(cfg, text=text)
    return cfg, K.params.init(cfg, 0, "cuda"), 3


def _decode_launches(monkeypatch, engine):
    """The kernels' launches made inside the engine's decode segments (a
    replayed step counted once a replay)."""
    counted = collections.Counter()
    real = engine_module._GroupRun.segment

    def segment(run, *args, **kw):
        before = collections.Counter(kernels.LAUNCHES)
        out = real(run, *args, **kw)
        counted.update(collections.Counter(kernels.LAUNCHES) - before)
        return out

    monkeypatch.setattr(engine_module._GroupRun, "segment", segment)
    return counted


@pytest.mark.cuda
@pytest.mark.parametrize("family", list(FAMILIES))
def test_a_captured_decode_step_runs_one_kernel_a_norm(monkeypatch, family):
    """Two text-only requests, 32 greedy tokens through the engine (decode
    graphed): every decode step launches the kernel once for each norm site
    (per layer 2, 4 or 3, and the final norm), and the tokens equal those
    of the same engine with the plain norm; each emitted token's
    log-probability within 0.05 of the plain path's (a few bf16 ulps of a
    logit)."""
    cuda_device()
    cfg, params, sites = _card_family(family)
    g = torch.Generator().manual_seed(5)
    reqs = [Request(torch.randint(5, 400, (n,), generator=g).tolist()) for n in (40, 27)]
    greedy = SamplingParams(temperature=0.0, repetition_penalty=1.05, max_tokens=32)
    outs = {}
    for path in ("kernel", "plain"):
        with monkeypatch.context() as m:
            if path == "plain":
                m.setattr(N, "kernel_takes", lambda x, weight, impl: False)
            engine = InferenceEngine(params, cfg)
            engine.generate(reqs, dataclasses.replace(greedy, max_tokens=2))  # first use
            launches = _decode_launches(m, engine)
            engine.decode_steps = engine.decode_steps_wasted = 0
            outs[path] = engine.generate(reqs, greedy, return_logprobs=True)
            ran = engine.decode_steps + engine.decode_steps_wasted
        assert ran > 0
        want = (sites * cfg.text.num_hidden_layers + 1) * ran if path == "kernel" else 0
        assert launches["rms_norm"] == want, (path, dict(launches), ran)
    for a, b in zip(outs["kernel"], outs["plain"]):
        assert a["token_ids"] == b["token_ids"]
        assert max(abs(x - y) for x, y in zip(a["logprobs"], b["logprobs"])) <= 0.05
