"""Sampling: the port's repetition penalty and top-p mask equal the JAX
package's on the same logits, and its draw equals ``torch.multinomial``'s at
the same generator state."""

import numpy as np
import pytest
import torch

from _torch_parity import normal, rng

from open_o3_video_tpu_torch.ops import sampling as tsamp


def _logits_with_ties(seed, b=4, v=1200):
    """(b, v) f32 logits; row 1 has an exact tie at its maximum and row 2 a
    tie straddling a likely nucleus boundary. V > 1024 takes JAX's top-512
    path, whose answer must equal the full sort's."""
    x = normal(rng(seed), b, v, scale=2.0)
    x[1, 7] = x[1, 11] = x[1].max() + 1.0
    order = np.argsort(-x[2])
    x[2, order[3]] = x[2, order[2]]
    return x


def test_repetition_penalty_matches_jax():
    import jax.numpy as jnp

    from open_o3_video_tpu.ops.sampling import apply_repetition_penalty

    x = _logits_with_ties(0)
    seen = rng(1).random(x.shape) < 0.3
    for penalty in (1.0, 1.05, 1.3):
        ours = tsamp.apply_repetition_penalty(torch.from_numpy(x), torch.from_numpy(seen), penalty)
        theirs = apply_repetition_penalty(jnp.asarray(x), jnp.asarray(seen), penalty)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("top_p", [0.001, 0.2, 0.6, 0.95])
@pytest.mark.parametrize("v", [100, 1200])
def test_top_p_mask_matches_jax(top_p, v):
    import jax.numpy as jnp

    from open_o3_video_tpu.ops.sampling import top_p_filter

    x = _logits_with_ties(2, v=v)
    ours = torch.isfinite(tsamp.top_p_filter(torch.from_numpy(x), top_p)).numpy()
    theirs = np.isfinite(np.asarray(top_p_filter(jnp.asarray(x), top_p)))
    np.testing.assert_array_equal(ours, theirs)
    assert ours[1, 7] and ours[1, 11]  # both tied maxima survive
    if top_p == 0.001:
        assert (ours.sum(-1)[[0, 3]] == 1).all()


def test_sample_token_greedy_and_nucleus():
    x = torch.from_numpy(_logits_with_ties(3))
    seen = torch.zeros(x.shape, dtype=torch.bool)
    greedy = tsamp.sample_token(None, x, temperature=0.0)
    assert greedy[1].item() == 7  # the first of tied maxima, as jnp.argmax
    assert torch.equal(greedy, x.argmax(-1))
    gen = torch.Generator().manual_seed(0)
    drawn = tsamp.sample_token(gen, x, temperature=0.7, top_p=0.001, seen_mask=seen,
                               repetition_penalty=1.05)
    assert torch.equal(drawn[[0, 2, 3]], greedy[[0, 2, 3]])
    assert drawn[1].item() in (7, 11)


@pytest.mark.parametrize("top_p", [1.0, 0.6])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_draw_equals_multinomial(seed, top_p):
    """sample_token's exponential race draws what torch.multinomial draws
    from the same probabilities at the same generator state (its one-sample
    path), with and without the top-p mask."""
    x = torch.from_numpy(_logits_with_ties(10 + seed))
    seen = torch.from_numpy(rng(seed).random(x.shape) < 0.2)
    kw = dict(temperature=0.7, top_p=top_p, seen_mask=seen, repetition_penalty=1.05)
    logits = tsamp.apply_repetition_penalty(x, seen, 1.05) / 0.7
    if top_p < 1.0:
        logits = tsamp.top_p_filter(logits, top_p)
    probs = torch.softmax(logits, dim=-1)
    for draw in range(3):
        state = 100 * seed + draw
        want = torch.multinomial(probs, 1, generator=torch.Generator().manual_seed(state))
        got = tsamp.sample_token(torch.Generator().manual_seed(state), x, **kw)
        assert torch.equal(got, want[:, 0])


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
@pytest.mark.parametrize("top_p", [1.0, 0.6])
def test_draw_refuses_what_multinomial_refuses(top_p, bad):
    """A NaN or inf among the logits makes the draw raise, as it makes
    torch.multinomial raise, instead of quietly giving a token."""
    x = torch.from_numpy(_logits_with_ties(5))
    x[2, 3] = bad
    logits = x / 0.7
    if top_p < 1.0:
        logits = tsamp.top_p_filter(logits, top_p)
    with pytest.raises(RuntimeError):
        torch.multinomial(torch.softmax(logits, dim=-1), 1, generator=torch.Generator())
    with pytest.raises(RuntimeError):
        tsamp.sample_token(torch.Generator().manual_seed(0), x, temperature=0.7, top_p=top_p)
