"""Runs with the timed path broken underneath come out not correct."""

import functools

import pytest
import torch

from portbench.tests._cells import CELLS, run_small, small


def _patch(obj, name, after):
    fn = getattr(obj, name)

    @functools.wraps(fn)
    def wrapped(*a, **kw):
        return after(fn(*a, **kw), *a, **kw)

    setattr(obj, name, wrapped)


def _bump(t):
    """One element off by one: an answer altered where it is produced."""
    t = t.clone()
    t.view(-1)[t.numel() // 3] += 1.0
    return t


def state_unchanged(st):
    """The carry a step hands on is the one it was given."""
    if st.stem.variant == "res":
        _patch(st.stem, "decompress", lambda out, s, sh, y_cond:
               {"y_hat": y_cond})
    else:
        _patch(st.stem, "fused_encode_sparse_carry_expr",
               lambda out, y_cur, y_cond, he=None: (out[0], y_cond))
        _patch(st.stem, "forward", lambda out, y_cur, y_cond, **kw:
               {**out, "y_hat": y_cond})


def half_batch(st):
    """g_a run on half of the pictures, its result given to all."""
    def after(out, x):
        h = out.shape[0] // 2
        return torch.cat([out[:h], out[:h]])
    _patch(st.i_model, "analysis", after)


def answer_altered(st):
    """One symbol of the decoded (or estimated) ŷ altered."""
    if st.stem.variant == "res":
        _patch(st.stem, "decompress", lambda out, *a:
               {"y_hat": _bump(out["y_hat"])})
    else:
        _patch(st.stem, "fused_reconstruct_sparse_expr",
               lambda out, *a: _bump(out))
        _patch(st.stem, "forward", lambda out, *a, **kw:
               {**out, "y_hat": _bump(out["y_hat"])})


@pytest.mark.parametrize("fault", [state_unchanged, half_batch,
                                   answer_altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_broken_path_is_not_correct(name, fault):
    torch.set_num_threads(2)
    out = run_small(small(name, dtype="float32"), fault=fault)
    assert not out["correct"], out["checks"]


def rate_altered(st):
    """The rate estimate without z's likelihoods."""
    _patch(st.stem, "forward", lambda out, *a, **kw:
           {**out, "likelihoods": {"y": out["likelihoods"]["y"]}})


def test_estimate_without_z_is_not_correct():
    torch.set_num_threads(2)
    out = run_small(small("without_spm_192.estimate_f32"), fault=rate_altered)
    assert not out["correct"], out["checks"]
    assert out["checks"]["bpp"]["value"] > out["checks"]["bpp"]["limit"]
