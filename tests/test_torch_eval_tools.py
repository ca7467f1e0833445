"""The port's eval tools, data/transforms.py, GDN1 and upper_bound against
the JAX package's on the CPU:

  * update_checkpoint on a bmshj2018-factorized q1 checkpoint the JAX
    package writes (tests/test_eval_tools.py:96-121, at its (8, 12)
    widths): the solved quantiles, the tables' CDFs, offsets and lengths
    equal; the export loads back through the port and compresses a 64²
    picture to the JAX-updated model's bytes; the train_state branch, the
    CLI, and a checkpoint with neither key raising;
  * find_closest, rd_data, plot (the CSV table with matplotlib blocked,
    the PNG with it), the JPEG codec against the JAX bench on one PNG
    (bytes, so bpp, equal; PSNR within 1e-4), a missing binary raising;
  * transforms (round trip and 4:2:0 shapes as tests/test_data.py:133-147,
    values within 1e-6 in both upsampling modes, NCHW against NHWC);
  * GDN1 forward and input gradient (f32, 1e-6) and upper_bound's value
    and pass-through gradient.
"""

import builtins
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spatiotemporalentropymodel_tpu.zoo as jzoo
import spatiotemporalentropymodel_tpu_torch.zoo as pzoo
from spatiotemporalentropymodel_tpu.data import transforms as jtf
from spatiotemporalentropymodel_tpu.eval import (
    bench_codecs as jbench, find_close as jfind, plot as jplot,
    rd_data as jrd, update_model as jupdate,
)
from spatiotemporalentropymodel_tpu.layers import GDN1 as JaxGDN1
from spatiotemporalentropymodel_tpu.ops import upper_bound as jax_upper
from spatiotemporalentropymodel_tpu.training.checkpoints import (
    load_checkpoint as jax_load, save_checkpoint as jax_save,
)
from spatiotemporalentropymodel_tpu_torch.convert import jax_tree
from spatiotemporalentropymodel_tpu_torch.data import transforms as ptf
from spatiotemporalentropymodel_tpu_torch.eval import (
    bench_codecs as pbench, find_close as pfind, plot as pplot,
    rd_data as prd, update_model as pupdate,
)
from spatiotemporalentropymodel_tpu_torch.layers import GDN1
from spatiotemporalentropymodel_tpu_torch.ops import upper_bound
from spatiotemporalentropymodel_tpu_torch.training.checkpoints import (
    load_checkpoint, save_checkpoint,
)

from torch_port_util import export_jax_tree, to_nchw, to_nhwc

ARCH = "bmshj2018-factorized"
WIDTHS = (8, 12)


def _write_png(path, h=96, w=128, seed=0):
    """tests/test_eval_tools.py's smooth test picture."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    x = np.linspace(0, 1, w)[None, :, None] * np.ones((h, 1, 3))
    x = (x + 0.1 * rng.random((h, w, 3))).clip(0, 1)
    Image.fromarray((x * 255).astype(np.uint8)).save(path)


# ---- update_model ----------------------------------------------------------


@pytest.fixture
def tiny_factorized(monkeypatch):
    """Both zoos' factorized-prior q1 at the JAX test's (8, 12)."""
    for zoo in (jzoo, pzoo):
        monkeypatch.setitem(zoo.cfgs[ARCH], 1, WIDTHS)


def _pair(seed):
    """A port FactorizedPrior(8, 12) from a seed and its JAX twin."""
    port = pzoo.create_model(ARCH, 1, device="cpu", seed=seed)
    jm = jzoo.create_model(ARCH, 1)
    jm.params = jax.tree_util.tree_map(jnp.asarray,
                                       export_jax_tree(port.module))
    return port, jm


@pytest.fixture
def updated(tiny_factorized, tmp_path):
    """A checkpoint the JAX package writes from trained-looking weights
    (quantiles moved off their optimum), updated by both packages into
    models that start from other weights."""
    src, jsrc = _pair(seed=1)
    with torch.no_grad():
        src.module.entropy_bottleneck.quantiles.mul_(1.3)
    jsrc.params = jax.tree_util.tree_map(jnp.asarray,
                                         export_jax_tree(src.module))
    ckpt = str(tmp_path / "train.pkl")
    jax_save({"model": jsrc.state_dict()}, ckpt)
    port, jm = _pair(seed=2)
    out_j = jupdate.update_checkpoint(jm, ckpt, str(tmp_path / "jax"))
    out_p = pupdate.update_checkpoint(port, ckpt, str(tmp_path / "port"))
    return port, jm, out_p, out_j, src


def test_update_checkpoint_matches_jax(updated):
    port, jm, out_p, out_j, src = updated
    q = port.module.entropy_bottleneck.quantiles.detach().numpy()
    np.testing.assert_array_equal(
        q, np.asarray(jm.params["entropy_bottleneck"]["quantiles"]))
    assert not np.array_equal(
        q, src.module.entropy_bottleneck.quantiles.detach().numpy())
    for name, jt in jm.tables.items():
        pt = port.tables[name]
        for field in ("cdf", "offset", "cdf_length"):
            np.testing.assert_array_equal(getattr(pt, field),
                                          getattr(jt, field))
    base = os.path.basename(out_p)
    assert base.startswith("model-") and base.endswith(".pkl")
    assert os.path.exists(out_p) and os.path.exists(out_j)
    restored = jax_load(out_j)["model"]
    assert len(restored["tables"]) == len(port.tables)


def test_update_export_loads_and_compresses_as_jax(updated):
    port, jm, out_p, _, _ = updated
    fresh = pzoo.create_model(ARCH, 1, device="cpu", seed=9)
    fresh.load_state_leaves(load_checkpoint(out_p)["model"])
    for a, b in zip(fresh.module.parameters(), port.module.parameters()):
        assert torch.equal(a, b)
    x = np.random.default_rng(3).random((1, 64, 64, 3), dtype=np.float32)
    got = fresh.compress(to_nchw(x))
    ref = jm.compress(jnp.asarray(x))
    assert got["strings"] == ref["strings"]
    assert tuple(got["shape"]) == tuple(ref["shape"])


def test_update_checkpoint_train_state_and_missing_keys(tiny_factorized,
                                                        tmp_path):
    src, _ = _pair(seed=4)
    ckpt = tmp_path / "state.pkl"
    save_checkpoint({"train_state": (jax_tree(src.module), {}, {},
                                     np.asarray(3, np.int32))}, ckpt)
    port, _ = _pair(seed=5)
    pupdate.update_checkpoint(port, str(ckpt), str(tmp_path / "o"),
                              solve_aux=False)
    for a, b in zip(port.module.parameters(), src.module.parameters()):
        assert torch.equal(a, b)
    save_checkpoint({"counters": {"iteration": np.asarray(1)}},
                    tmp_path / "bad.pkl")
    with pytest.raises(KeyError, match="train_state"):
        pupdate.update_checkpoint(port, str(tmp_path / "bad.pkl"),
                                  str(tmp_path / "o"))


def test_update_model_cli(tiny_factorized, tmp_path, capsys):
    src, _ = _pair(seed=6)
    ckpt = tmp_path / "m.pkl"
    save_checkpoint({"model": src.state_tree()}, ckpt)
    pupdate.main([str(ckpt), "-a", ARCH, "-q", "1", "-d",
                  str(tmp_path / "out"), "-n", "fp", "--device", "cpu"])
    out = capsys.readouterr().out.strip()
    assert os.path.basename(out).startswith("fp-") and os.path.exists(out)


# ---- find_close, rd_data, plot ---------------------------------------------


@pytest.mark.parametrize("target", [20.0, 35.0, 47.3, 80.0])
def test_find_closest_matches_jax(target):
    def ev(q):
        return {"psnr": 20 + q / 2}

    assert pfind.find_closest(ev, target, "psnr", 1, 95) == \
        jfind.find_closest(ev, target, "psnr", 1, 95)


def test_rd_data_matches_jax():
    for name in ("UVG", "HEVC_B", "UVG_HEADLINE"):
        assert getattr(prd, name) == getattr(jrd, name)


RESULTS = {"name": "test", "results": {"bpp": [0.1, 0.2],
                                       "psnr": [30.0, 33.0]}}


@pytest.mark.parametrize("baselines", ["uvg", "hevc-b", "none"])
def test_plot_csv_matches_jax(baselines, tmp_path, monkeypatch):
    """With matplotlib blocked both write the same CSV table."""
    real_import = builtins.__import__

    def no_matplotlib(name, *a, **kw):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("blocked")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    p = tmp_path / "res.json"
    p.write_text(json.dumps(RESULTS))
    for mod, out in ((pplot, "port.csv"), (jplot, "jax.csv")):
        mod.plot(mod.load_results([str(p)]), "psnr", baselines,
                 str(tmp_path / out))
    text = (tmp_path / "port.csv").read_text()
    assert text == (tmp_path / "jax.csv").read_text()
    assert text.startswith("series,bpp,psnr")


def test_plot_png(tmp_path):
    p = tmp_path / "res.json"
    p.write_text(json.dumps(RESULTS))
    out = tmp_path / "curve.png"
    pplot.main([str(p), "-o", str(out)])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


# ---- bench_codecs ----------------------------------------------------------


def test_jpeg_bench_matches_jax(tmp_path):
    _write_png(tmp_path / "a.png")
    paths, qs = [str(tmp_path / "a.png")], [30, 80]
    got = pbench.bench("jpeg", paths, qs, workers=1)["results"]
    ref = jbench.bench("jpeg", paths, qs, workers=1)["results"]
    assert got.keys() == ref.keys()
    assert got["bpp"] == ref["bpp"]
    np.testing.assert_allclose(got["psnr"], ref["psnr"], atol=1e-4)
    assert all(np.isnan(v) for v in got["ms-ssim"] + ref["ms-ssim"])
    assert got["bpp"][1] > got["bpp"][0] and got["psnr"][1] > got["psnr"][0]


@pytest.mark.parametrize("name", ["bpg", "vtm", "hm", "av1", "tfci"])
def test_missing_binary_raises(name):
    codec = pbench.get_codec(name)
    assert codec.available() is False
    if name == "bpg":
        with pytest.raises(RuntimeError):
            codec.run("nope.png", 30)
    with pytest.raises(ValueError):
        pbench.get_codec("nope")


# ---- transforms, GDN1, upper_bound -----------------------------------------


def test_transforms_round_trip_and_shapes():
    rng = np.random.default_rng(0)
    rgb = torch.from_numpy(rng.random((2, 3, 16, 16)).astype(np.float32))
    torch.testing.assert_close(ptf.ycbcr2rgb(ptf.rgb2ycbcr(rgb)), rgb,
                               atol=1e-5, rtol=0)
    x = torch.from_numpy(rng.random((1, 3, 32, 32)).astype(np.float32))
    y, u, v = ptf.yuv_444_to_420(x)
    assert y.shape == (1, 1, 32, 32) and u.shape == v.shape == (1, 1, 16, 16)
    assert ptf.yuv_420_to_444((y, u, v)).shape == (1, 3, 32, 32)
    with pytest.raises(ValueError):
        ptf.rgb2ycbcr(torch.zeros(1, 4, 8, 8))


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_transforms_match_jax(mode):
    x = np.random.default_rng(1).random((2, 16, 24, 3)).astype(np.float32)
    for pfn, jfn in ((ptf.rgb2ycbcr, jtf.rgb2ycbcr),
                     (ptf.ycbcr2rgb, jtf.ycbcr2rgb)):
        np.testing.assert_allclose(to_nhwc(pfn(to_nchw(x))),
                                   np.asarray(jfn(jnp.asarray(x))),
                                   atol=1e-6)
    planes = ptf.yuv_444_to_420(to_nchw(x))
    jplanes = jtf.yuv_444_to_420(jnp.asarray(x))
    for p, j in zip(planes, jplanes):
        np.testing.assert_allclose(to_nhwc(p), np.asarray(j), atol=1e-6)
    got = ptf.yuv_420_to_444(planes, mode)
    ref = jtf.yuv_420_to_444(jplanes, mode)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(ref), atol=1e-6)
    parts = ptf.yuv_420_to_444(planes, mode, return_tuple=True)
    assert torch.equal(torch.cat(parts, dim=1), got)


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn1_matches_jax(inverse):
    c = 8
    layer = GDN1(c, inverse=inverse)
    rng = np.random.default_rng(2)
    with torch.no_grad():  # off the initial identity γ
        layer.gamma.add_(torch.from_numpy(
            0.05 * rng.random((c, c)).astype(np.float32)))
    params = {"beta": layer.beta.detach().numpy(),
              "gamma": layer.gamma.detach().numpy()}
    x = rng.standard_normal((2, 5, 6, c)).astype(np.float32)
    w = rng.standard_normal((2, 5, 6, c)).astype(np.float32)
    jmod = JaxGDN1(c, inverse=inverse)

    def jloss(v):
        return jnp.sum(jmod.apply({"params": params}, v) * w)

    ref = jmod.apply({"params": params}, jnp.asarray(x))
    ref_g = jax.grad(jloss)(jnp.asarray(x))
    xt = to_nchw(x).requires_grad_(True)
    out = layer(xt)
    (g,) = torch.autograd.grad((out * to_nchw(w)).sum(), xt)
    np.testing.assert_allclose(to_nhwc(out), np.asarray(ref), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(to_nhwc(g), np.asarray(ref_g), atol=1e-6,
                               rtol=1e-6)
    assert layer(to_nchw(x).bfloat16()).dtype == torch.bfloat16


def test_upper_bound_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.uniform(-2, 2, 64).astype(np.float32)
    g = rng.standard_normal(64).astype(np.float32)
    x[:4] = 0.5  # on the bound
    out, vjp = jax.vjp(lambda v: jax_upper(v, 0.5), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = upper_bound(xt, 0.5)
    (gt,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    np.testing.assert_array_equal(gt.numpy(),
                                  np.asarray(vjp(jnp.asarray(g))[0]))
    # blocked where x is above the bound and the gradient would raise it
    assert np.any((x > 0.5) & (gt.numpy() == 0))
