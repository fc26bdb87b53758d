"""Context parallelism in the port (``ops/ring_attention.py``,
``parallel/context.py``) against the JAX package's unsharded functions, at
tiny dims in float32 on the CPU. One group of four gloo ranks
(``_torch_dist.check_context``) at context 2 (data 2 x context 2) and
context 4:

- ring attention, both versions (the kernels' path: K3 exact per block at
  shifted positions, the online-softmax combine and K5 per block, here
  their plain versions; and JAX's einsum recurrence), GQA and MHA, padded
  and unpadded: the output and dq, dk, dv against JAX's exact XLA
  ``causal_attention`` and its ``jax.vjp`` over the whole sequence, within
  2e-5 (JAX's bound for its ring, ``tests/test_context_parallel.py:63``),
  on valid query rows;
- ``cp_text_forward`` against JAX's ``text_forward`` (5e-5) and
  ``cp_per_token_logps`` against JAX's unsharded log-probabilities (1e-4),
  with a left-padded row; the gradients of a weighted sum of the
  log-probabilities w.r.t. every decoder leaf, summed over ``context``,
  against ``jax.grad`` of the same sum (1e-4 of each leaf's scale).
"""

import numpy as np
import pytest
import torch

from _torch_dist import run_group
from _torch_parity import model_pair

from open_o3_video_tpu_torch.models.qwen25vl import params as TP

B, S, D = 2, 16, 8
CASES = {"gqa_padded": (4, 2, [0, 5]), "gqa": (4, 2, [0, 0]), "mha_padded": (4, 4, [3, 0]),
         "mha": (2, 2, [0, 0])}


def _attention_inputs():
    r = np.random.default_rng(5)
    out = {}
    for name, (hq, hkv, pads) in CASES.items():
        q, k, v = (r.standard_normal((B, S, h, D)).astype(np.float32) for h in (hq, hkv, hkv))
        valid = np.ones((B, S), bool)
        for i, p in enumerate(pads):
            valid[i, :p] = False
        # padded query rows are never read, so no gradient reaches them (JAX's
        # XLA path gives them self-attention, the port zeros)
        dout = r.standard_normal((B, S, hq, D)).astype(np.float32) * valid[:, :, None, None]
        out[name] = (q, k, v, valid, dout)
    return out


def _jax_attention(inputs):
    import jax
    import jax.numpy as jnp

    from open_o3_video_tpu.ops.attention import causal_attention

    refs = {}
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    for name, (q, k, v, valid, dout) in inputs.items():
        fn = lambda q, k, v, valid=jnp.asarray(valid): causal_attention(  # noqa: E731
            q, k, v, q_positions=pos, kv_positions=pos, kv_mask=valid, impl="xla")
        out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
        refs[name] = (np.asarray(out), *(np.asarray(g) for g in vjp(jnp.asarray(dout))))
    return refs


def _jax_decoder(jcfg, jparams, inp):
    import jax
    import jax.numpy as jnp

    from open_o3_video_tpu.models.qwen25vl.text import logits_from_hidden, text_forward

    def logps(text):
        hidden, _ = text_forward(text, jcfg.text, jnp.asarray(inp["embeds"]),
                                 jnp.asarray(inp["pos"]), attn_valid=jnp.asarray(inp["valid"]))
        lp = jax.nn.log_softmax(logits_from_hidden(text, hidden), axis=-1)
        return hidden, jnp.take_along_axis(lp, jnp.asarray(inp["targets"])[..., None], -1)[..., 0]

    hidden, lp = jax.jit(logps)(jparams["text"])
    grads = jax.jit(jax.grad(lambda t: (logps(t)[1] * jnp.asarray(inp["weights"])).sum()))(
        jparams["text"])
    return np.asarray(hidden), np.asarray(lp), jax.tree.map(np.asarray, grads)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    jcfg, jparams, tcfg, tparams = model_pair(0)
    r = np.random.default_rng(6)
    valid = np.ones((B, S), bool)
    valid[1, :3] = False  # left padding
    pos = np.broadcast_to(np.where(valid, np.cumsum(valid, 1) - 1, 1)[None], (3, B, S)).copy()
    inp = {"attention": _attention_inputs(), "cfg": tcfg, "params": tparams,
           "embeds": r.standard_normal((B, S, tcfg.text.hidden_size)).astype(np.float32),
           "pos": pos, "valid": valid,
           "targets": r.integers(0, tcfg.text.vocab_size, (B, S)),
           "weights": (r.random((B, S)) * valid).astype(np.float32)}
    work = tmp_path_factory.mktemp("context")
    torch.save(inp, work / "inputs.pt")

    def refs():
        return _jax_attention(inp["attention"]), _jax_decoder(jcfg, jparams, inp)

    outs, ref = run_group("context", 4, work, meanwhile=refs)
    return inp, outs, ref


@pytest.mark.parametrize("impl", ["auto", "torch"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("n", [2, 4])
def test_ring_attention_matches_jax(group, n, case, impl):
    inp, outs, (attn, _) = group
    valid = inp["attention"][case][3]
    for out in outs:
        got = out[(n, case, impl)]
        for name, a, b in zip(("out", "dq", "dk", "dv"), got, attn[case]):
            if name in ("out", "dq"):  # padded query rows are never read
                a, b = a[valid], b[valid]
            np.testing.assert_allclose(a, b, atol=2e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("n", [2, 4])
def test_cp_forward_and_logps_match_jax(group, n):
    inp, outs, (_, (hidden, logps, _)) = group
    valid = inp["valid"]
    for out in outs:
        np.testing.assert_allclose(out[(n, "hidden")][valid], hidden[valid], atol=5e-5, rtol=0)
        np.testing.assert_allclose(out[(n, "logps")][valid], logps[valid], atol=1e-4, rtol=0)


@pytest.mark.parametrize("n", [2, 4])
def test_cp_logps_gradients_match_jax(group, n):
    import jax

    inp, outs, (_, (_, _, grads)) = group
    theirs = jax.tree.leaves(grads)
    for out in outs:
        ours = out[(n, "grads")]
        assert len(ours) == len(theirs)
        for a, b in zip(_jax_order(inp, ours), theirs):
            np.testing.assert_allclose(a, b, atol=1e-4 * np.abs(b).max(), rtol=0)


def _jax_order(inp, leaves):
    """The port's decoder leaves (``params.leaves`` order) in JAX's tree
    order, through ``to_jax_layout`` of a tree holding them."""
    import jax

    text = inp["params"]["text"]
    it = iter(leaves)

    def fill(t):
        if isinstance(t, dict):
            return {k: fill(v) for k, v in t.items()}
        if isinstance(t, list):
            return [fill(v) for v in t]
        return torch.as_tensor(next(it))

    filled = fill(text)
    return jax.tree.leaves(TP.to_jax_layout({"text": filled})["text"])
