"""The port's parallel/ against the JAX package's on the CPU, the JAX side
on the 8 virtual host devices of tests/conftest.py, the port's on meshes
that name the CPU several times (parallel/mesh.py).

  * data_parallel_step on a 2-entry mesh against JAX's on make_mesh(2)
    (tests/test_parallel.py:60-76), the STEM res sequence step and the image
    step at N = M = EB = 16, B = 4, with the fed noise of
    tests/test_torch_train_step.py and its tolerances (losses rtol 1e-4,
    gradients within 1e-4 of max|g|, parameters within 1e-6 where the
    gradients pin Adam's step); on a 1-entry mesh the step is the plain
    step exactly;
  * train_image and train_stem per_sequence with data_parallel on a
    2-entry mesh against the same runs without it; per_frame and
    train_stem_roi accept the flag and leave it unread;
  * gop_forward_sharded on a mesh of 8 against JAX's (test_parallel.py:
    114-150, B = 8, 64², M = 8): x̂ atol 1e-5, bpp rtol 1e-5;
  * spatial_apply of analysis, get_x and STEM hyper_encode against JAX's
    at 1×3×64×128 on a mesh of 8 (:153-215), atol 1e-5, the output
    Sharded; a halo one stride short differs; shard_frame raises on W = 12,
    and an output that does not split comes back whole;
  * the W-split StemVideoPipeline against the JAX one (:218-310:
    1×3×64×512, weights × 0.05, mesh 8): streams and counts byte for byte,
    one frame and a two-frame GOP, x̂ and ŷ within 1e-5, the carry Sharded.

Weights are drawn by the port and carried to the JAX side
(``export_jax_tree``): a JAX init costs seconds per op here.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatiotemporalentropymodel_tpu import parallel as jpar
from spatiotemporalentropymodel_tpu.eval.pipeline import (
    StemVideoPipeline as JaxPipeline,
)
from spatiotemporalentropymodel_tpu.models import (
    MeanScaleHyperprior as JaxMSH,
    STEMModule as JaxSTEM,
    SpatioTemporalPriorModel as JaxStem,
)
from spatiotemporalentropymodel_tpu.parallel import train_step as jts
from spatiotemporalentropymodel_tpu_torch.eval.pipeline import (
    StemVideoPipeline,
)
from spatiotemporalentropymodel_tpu_torch.models import (
    MeanScaleHyperprior,
    STEMModule,
    SpatioTemporalPriorModel,
)
from spatiotemporalentropymodel_tpu_torch.parallel import (
    SP_AXIS,
    Mesh,
    Sharded,
    data_parallel_step,
    shard_batch,
    shard_frame,
    spatial_apply,
)
from spatiotemporalentropymodel_tpu_torch.parallel import train_step as pts
from spatiotemporalentropymodel_tpu_torch.parallel import mesh as mesh_mod
from spatiotemporalentropymodel_tpu_torch.parallel.mesh import (
    replica, replica_on,
)
from spatiotemporalentropymodel_tpu_torch.parallel.spatial import (
    method_halo, whole,
)
from spatiotemporalentropymodel_tpu_torch.training import train_image as ti
from spatiotemporalentropymodel_tpu_torch.training import train_stem as ts
from spatiotemporalentropymodel_tpu_torch.training import (
    train_stem_roi as troi,
)
from spatiotemporalentropymodel_tpu_torch.utils import config as pconfig

from test_torch_cuda import check_replicas
from test_torch_train_step import _jax_pair, _port_pair, _run_steps
from torch_port_util import (  # noqa: F401 (fed_noise: a fixture)
    export_jax_tree, fed_noise, to_nchw, to_nhwc,
)

N = M = EBC = 16
B, HW, T = 4, 64, 3
LMBDA = 1e-2
CPU2 = Mesh(("cpu", "cpu"))
CPU8 = Mesh(("cpu",) * 8)
SP8 = Mesh(("cpu",) * 8, SP_AXIS)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# ---- data_parallel_step ----------------------------------------------------


def _latents(seed=1):
    """(B, T, 4, 4, M) NHWC latents, frame 0 rounded (the quantized
    carry)."""
    rng = np.random.default_rng(seed)
    lat = (3.0 * rng.standard_normal((B, T, HW // 16, HW // 16, M))).astype(
        np.float32)
    lat[:, 0] = np.round(lat[:, 0])
    return lat


def _seq(lat):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(lat, -1, 2)))


@pytest.fixture(scope="module")
def step_cases():
    """name → (JAX module, its make_*_step, port module maker, port step
    maker, JAX batch, port batch), the weights drawn by the port."""
    x = np.random.default_rng(0).random((B, HW, HW, 3), dtype=np.float32)
    lat = _latents()
    msh = MeanScaleHyperprior(N, M, device="cpu", seed=2).module
    stem = STEMModule("res", EBC, M, torch.Generator().manual_seed(3))
    return {
        "image": (JaxMSH(N, M).module, export_jax_tree(msh),
                  lambda m, o: jts.make_image_train_step(m, o, LMBDA),
                  msh, lambda m, o: pts.make_image_train_step(m, o, LMBDA),
                  jnp.asarray(x), to_nchw(x)),
        "stem_res": (JaxSTEM(variant="res", entropy_bottleneck_channels=EBC,
                             in_channels=M), export_jax_tree(stem),
                     jts.make_stem_train_step, stem,
                     pts.make_stem_train_step, jnp.asarray(lat), _seq(lat)),
    }


@pytest.mark.parametrize("case", ["image", "stem_res"])
def test_data_parallel_step_matches_jax(fed_noise, step_cases, case):
    """Two data-parallel updates on a 2-entry mesh against the JAX
    package's data_parallel_step on make_mesh(2), each from equal states."""
    jmod, params, jmake, pmod, pmake, jbatch, pbatch = step_cases[case]
    port = copy.deepcopy(pmod)
    opt, state = _jax_pair(params)
    popt, pstate = _port_pair(port)
    mesh = jpar.make_mesh(2)
    jstep = jpar.data_parallel_step(jmake(jmod, opt), mesh)
    counts = _run_steps(
        lambda st, b, k: jstep(jpar.replicate(st, mesh),
                               jpar.shard_batch(b, mesh), k),
        data_parallel_step(pmake(port, popt), CPU2), state, pstate,
        lambda i: (jbatch, jax.random.PRNGKey(i)),
        lambda i: (pbatch, torch.Generator()), port)
    print(f"{case} data-parallel steps: {counts} entries not pinned")


@pytest.mark.parametrize("case", ["image", "stem_res"])
def test_data_parallel_step_one_entry_is_the_step(step_cases, case):
    """On a mesh of one entry the shard draws from the caller's generator:
    two steps give the plain step's metrics, parameters and Adam moments
    exactly."""
    _, _, _, pmod, pmake, _, batch = step_cases[case]
    runs = []
    for wrap in (lambda s: s, lambda s: data_parallel_step(s, Mesh(("cpu",)))):
        module = copy.deepcopy(pmod)
        opt, state = _port_pair(module)
        step = wrap(pmake(module, opt))
        gen = torch.Generator().manual_seed(7)
        metrics = [step(state, batch, gen)[1] for _ in range(2)]
        moments = [t.clone() for o in opt[:2] for s in o.state.values()
                   for t in (s["exp_avg"], s["exp_avg_sq"])]
        runs.append((metrics, [p.detach().clone()
                               for p in module.parameters()], moments))
    (m0, p0, v0), (m1, p1, v1) = runs
    for a, b in zip(m0, m1):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(a, b) for a, b in zip(p0 + v0, p1 + v1))


def test_data_parallel_step_through_a_replica(monkeypatch):
    """A mesh that names the CPU by two names ("cpu", "cpu:0") runs its
    second shard through a replica, made once and synced before each step:
    two steps apply, bit for bit, the by-hand mean of the shards'
    gradients (test_torch_cuda.py::check_replicas, which the card runs on
    the card and the CPU, and on every card)."""
    made, real = [], mesh_mod.replica
    monkeypatch.setattr(mesh_mod, "replica",
                        lambda m, d: made.append(d) or real(m, d))
    check_replicas(monkeypatch, Mesh(("cpu", "cpu:0")))
    assert made == [torch.device("cpu:0")]


def test_data_parallel_step_shards_draw_their_own_noise(step_cases):
    """With real noise the shards' draws differ from the one-device
    step's, and a batch that does not divide the mesh raises."""
    _, _, _, pmod, pmake, _, batch = step_cases["image"]
    losses = []
    for mesh in (Mesh(("cpu",)), CPU2):
        module = copy.deepcopy(pmod)
        opt, state = _port_pair(module)
        step = data_parallel_step(pmake(module, opt), mesh)
        losses.append(float(step(state, batch, torch.Generator())[1]["loss"]))
    assert losses[0] != losses[1]
    assert np.isclose(losses[0], losses[1], rtol=0.05)
    with pytest.raises(ValueError):
        shard_batch(batch[:3], CPU2)


# ---- the trainers ---------------------------------------------------------


def _train_image(tmp, dp):
    cfg = pconfig.TrainImageConfig(cropsize=64, batch_size=4, seed=3,
                                   device="cpu", data_parallel=dp,
                                   workdir=str(tmp))
    model = MeanScaleHyperprior(N, M, device="cpu", seed=4)
    _, metrics = ti.train_image(cfg, max_steps=2, model=model)
    return metrics, model.module


def _train_stem(tmp, dp, mode):
    cfg = pconfig.TrainStemConfig(
        in_channels=M, entropy_bottleneck_channels=EBC, cropsize=64,
        batch_size=4, seed=3, device="cpu", step_mode=mode,
        data_parallel=dp, workdir=str(tmp))
    i_model = MeanScaleHyperprior(N, M, device="cpu", seed=4)
    state, metrics = ts.train_stem(cfg, max_steps=2, i_model=i_model)
    return metrics, state.module


def _assert_runs_close(a, b, updates, lr=1e-4):
    (ma, pa), (mb, pb) = a, b
    assert ma.keys() == mb.keys()
    for k in ma:
        np.testing.assert_allclose(float(ma[k]), float(mb[k]), rtol=1e-4)
    for (name, x), y in zip(pa.named_parameters(), pb.parameters()):
        assert float((x - y).detach().abs().max()) <= 2 * lr * updates, name


@pytest.mark.parametrize("entry", ["train_image", "train_stem"])
def test_trainers_data_parallel(fed_noise, entry, tmp_path, monkeypatch):
    """data_parallel=True on a 2-entry mesh trains two steps as the run
    without it does (fed noise; per_sequence for train_stem); on the
    default mesh of the CPU, one entry, the two runs are equal."""
    def run(dp, tag):
        if entry == "train_image":
            return _train_image(tmp_path / tag, dp)
        return _train_stem(tmp_path / tag, dp, "per_sequence")

    plain = run(False, "plain")
    one = run(True, "one")
    for k in plain[0]:
        assert torch.equal(plain[0][k], one[0][k]), k
    for x, y in zip(plain[1].parameters(), one[1].parameters()):
        assert torch.equal(x, y)
    for mod in (ti, ts):
        monkeypatch.setattr(mod, "training_mesh", lambda device: CPU2)
    _assert_runs_close(run(True, "two"), plain, 2)


def test_per_frame_and_roi_accept_data_parallel(tmp_path, monkeypatch):
    """train_stem per_frame and train_stem_roi take data_parallel=True and
    do not read it, as the JAX package's do: the run equals the one
    without it."""
    monkeypatch.setattr(ts, "data_parallel_step", None)
    runs = [_train_stem(tmp_path / str(dp), dp, "per_frame")
            for dp in (False, True)]
    for x, y in zip(runs[0][1].parameters(), runs[1][1].parameters()):
        assert torch.equal(x, y)
    cfg = pconfig.TrainStemRoiConfig(
        mode="baseline", in_channels=12, entropy_bottleneck_channels=16,
        cropsize=64, batch_size=1, device="cpu", data_parallel=True,
        workdir=str(tmp_path / "roi"))
    assert troi.training_device(cfg).type == "cpu"
    assert "data_parallel" not in troi.train_stem_roi.__code__.co_names


# ---- gop_forward_sharded ---------------------------------------------------


def _slice_models(m, ebc, scale=None, seed=0):
    """Port MSH(8, m) and without_spm STEM (EB ebc) from seeds, optionally
    scaled, with their JAX twins carrying the same weights."""
    pi = MeanScaleHyperprior(8, m, device="cpu", seed=seed)
    ps = SpatioTemporalPriorModel(variant="without_spm",
                                  entropy_bottleneck_channels=ebc,
                                  in_channels=m, device="cpu", seed=seed + 1)
    if scale is not None:
        with torch.no_grad():
            for p in [*pi.module.parameters(), *ps.module.parameters()]:
                p.mul_(scale)
    ps.update()
    ji = JaxMSH(8, m)
    ji.params = _jnp(export_jax_tree(pi.module))
    js = JaxStem(variant="without_spm", entropy_bottleneck_channels=ebc,
                 in_channels=m)
    js.params = _jnp(export_jax_tree(ps.module))
    js.update(force=True)
    return pi, ps, ji, js


def test_gop_forward_sharded_matches_jax():
    pi, ps, ji, js = _slice_models(8, 8)
    x = np.random.default_rng(0).random((8, 64, 64, 3), dtype=np.float32)
    frames = np.stack([x, x * 0.95 + 0.02])
    jpipe = JaxPipeline(ji, js)
    jy0 = jpipe.analysis(jnp.asarray(x))
    jx, jbpp = jpipe.gop_forward_sharded(jnp.asarray(frames), jy0,
                                         jpar.make_mesh(8))
    pipe = StemVideoPipeline(pi, ps)
    pframes = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(frames, -1, 2)))
    y0 = pipe.analysis(to_nchw(x))
    px, pbpp = pipe.gop_forward_sharded(pframes, y0, CPU8)
    ref_x, ref_bpp = pipe.gop_forward(pframes, y0)
    np.testing.assert_allclose(np.moveaxis(px.numpy(), 2, -1),
                               np.asarray(jx), atol=1e-5)
    np.testing.assert_allclose(pbpp.numpy(), np.asarray(jbpp), rtol=1e-5)
    np.testing.assert_allclose(px.numpy(), ref_x.numpy(), atol=1e-5)
    np.testing.assert_allclose(pbpp.numpy(), ref_bpp.numpy(), rtol=1e-5)
    with pytest.raises(ValueError):
        pipe.gop_forward_sharded(pframes[:, :6], y0[:6], Mesh(("cpu",) * 4))


# ---- spatial_apply ----------------------------------------------------------


@pytest.fixture(scope="module")
def spatial():
    """MSH(8, 16) and a without_spm STEM (EB 16, M 16) in both packages, a
    1×3×64×128 frame, a latent, and the meshes of 8."""
    pi = MeanScaleHyperprior(8, 16, device="cpu", seed=5)
    ji = JaxMSH(8, 16)
    ji.params = _jnp(export_jax_tree(pi.module))
    ps = SpatioTemporalPriorModel(variant="without_spm",
                                  entropy_bottleneck_channels=16,
                                  in_channels=16, device="cpu", seed=6)
    js = JaxStem(variant="without_spm", entropy_bottleneck_channels=16,
                 in_channels=16)
    js.params = _jnp(export_jax_tree(ps.module))
    x = np.random.default_rng(0).random((1, 64, 128, 3), dtype=np.float32)
    y = (0.3 * np.random.default_rng(2).standard_normal((1, 16, 32, 16))
         ).astype(np.float32)
    return pi, ji, ps, js, x, y, jpar.make_spatial_mesh(8)


def _jax_spatial(case, ji, js, x, y, jmesh):
    if case == "analysis":
        return jpar.spatial_apply(ji, "analysis", jnp.asarray(x), jmesh)[0]
    if case == "get_x":
        y_a = ji._apply(jnp.asarray(x), method="analysis")[0]
        return jpar.spatial_apply(ji, "get_x", y_a, jmesh, gather=True)
    repl = jax.sharding.NamedSharding(jmesh, jax.sharding.PartitionSpec())
    fn = jax.jit(
        lambda p, a, b: js.module.apply({"params": p}, a, b,
                                        method="hyper_encode"),
        in_shardings=(repl, jpar.frame_sharding(jmesh),
                      jpar.frame_sharding(jmesh)))
    return fn(jax.device_put(js.params, repl),
              jpar.shard_frame(jnp.asarray(y), jmesh),
              jpar.shard_frame(jnp.asarray(y), jmesh))


def _port_spatial(case, pi, ps, x, y, **kw):
    if case == "analysis":
        return spatial_apply(pi, "analysis", to_nchw(x), SP8, **kw)
    if case == "get_x":
        return spatial_apply(pi, "get_x", pi.analysis(to_nchw(x)), SP8,
                             **kw)
    return spatial_apply(ps, "hyper_encode", (to_nchw(y), to_nchw(y)), SP8,
                         **kw)


@pytest.mark.parametrize("case", ["analysis", "get_x", "hyper_encode"])
def test_spatial_apply_matches_jax(spatial, case):
    pi, ji, ps, js, x, y, jmesh = spatial
    ref = np.asarray(_jax_spatial(case, ji, js, x, y, jmesh))
    got = _port_spatial(case, pi, ps, x, y)
    assert isinstance(got, Sharded) and len(got.shards) == 8
    assert all(s.shape[3] == got.shape[3] // 8 for s in got.shards)
    np.testing.assert_allclose(to_nhwc(got.gather()), ref, atol=1e-5)
    whole = _port_spatial(case, pi, ps, x, y, gather=True)
    assert torch.equal(whole, got.gather())


@pytest.mark.parametrize("case", ["analysis", "get_x", "hyper_encode"])
def test_spatial_halo_one_stride_short_differs(spatial, case):
    """The halo each method gets (g_a 32, g_s 2, HE 8 columns) is the
    least that gives the unsplit result: one stride (16, 1, 4) less
    changes the columns by the interior cuts."""
    pi, _, ps, _, x, y, _ = spatial
    model = ps if case == "hyper_encode" else pi
    halo = method_halo(model, case)
    short = halo - {"analysis": 16, "get_x": 1, "hyper_encode": 4}[case]
    assert halo == {"analysis": 32, "get_x": 2, "hyper_encode": 8}[case]
    full = _port_spatial(case, pi, ps, x, y).gather()
    cut = _port_spatial(case, pi, ps, x, y, halo=short).gather()
    assert float((full - cut).abs().max()) > 1e-3 * float(full.abs().max())


def test_shard_frame_rejects_indivisible_w():
    with pytest.raises(ValueError):
        shard_frame(torch.zeros(1, 3, 8, 12), SP8)


def test_spatial_apply_computes_unsplittable_outputs_whole():
    """8 columns a shard are half a latent column: the latent comes back
    whole, computed on the first device (the JAX package replicates an
    output whose W does not divide the mesh)."""
    model = MeanScaleHyperprior(8, 16, device="cpu")
    x = torch.rand(1, 3, 16, 64, generator=torch.Generator().manual_seed(1))
    got = spatial_apply(model, "analysis", x, SP8)
    assert torch.is_tensor(got)
    assert torch.equal(got, model.analysis(x))


# ---- the W-split serving pipeline -------------------------------------------


@pytest.fixture(scope="module")
def spatial_serving():
    """The JAX test's setup (W = 512 = 8 shards × 16 × 4), weights × 0.05
    so the sparse transport stays in band: the port's pipelines unsplit
    and W-split over 8 entries, the JAX package's W-sharded one."""
    pi, ps, ji, js = _slice_models(8, 8, scale=0.05, seed=10)
    x = np.random.default_rng(0).random((1, 64, 512, 3), dtype=np.float32)
    return (x, StemVideoPipeline(pi, ps),
            StemVideoPipeline(pi, ps, spatial_mesh=SP8),
            JaxPipeline(ji, js, spatial_mesh=jpar.make_spatial_mesh(8)))


def _same_streams(a, b):
    assert a["transport"] == b["transport"] == "sparse"
    assert a["strings"] == b["strings"]
    np.testing.assert_array_equal(np.asarray(a["counts"]),
                                  np.asarray(b["counts"]))


def test_spatial_pipeline_frame_matches_jax(spatial_serving):
    x, ref, sp, jsp = spatial_serving
    xt, xj = to_nchw(x), jnp.asarray(x)
    enc_j, _ = jsp.encode_frame(xj, jsp.analysis(xj * 0.9))
    enc_ref, carry_ref = ref.encode_frame(xt, ref.analysis(xt * 0.9))
    y0 = sp.analysis(xt * 0.9)
    assert isinstance(y0, Sharded)
    enc_sp, carry_sp = sp.encode_frame(xt, y0)
    _same_streams(enc_sp, enc_j)
    _same_streams(enc_sp, enc_ref)
    assert isinstance(carry_sp, Sharded) and len(carry_sp.shards) == 8
    assert torch.equal(carry_sp.gather(), carry_ref)
    xh_j, yh_j = jsp.decode_frame(enc_j, y_cond=jsp.analysis(xj * 0.9))
    xh, yh = sp.decode_frame(enc_sp, y_cond=y0)
    assert isinstance(yh, Sharded) and isinstance(xh, Sharded)
    assert torch.equal(yh.gather(), carry_ref)
    np.testing.assert_allclose(to_nhwc(yh.gather()), np.asarray(yh_j),
                               atol=1e-5)
    np.testing.assert_allclose(to_nhwc(xh.gather()), np.asarray(xh_j),
                               atol=1e-5)


def test_spatial_pipeline_gop_matches_jax(spatial_serving):
    """A two-frame GOP through encode_frames and decode_frames, the carry
    split over the mesh from frame to frame."""
    x, ref, sp, jsp = spatial_serving
    frames = [x, np.clip(x * 0.97 + 0.01, 0, 1)]
    xj = jnp.asarray(x)
    j_encs = list(jsp.encode_frames(iter(map(jnp.asarray, frames)),
                                    jsp.analysis(xj * 0.9)))
    y0 = sp.analysis(to_nchw(x) * 0.9)
    encs = list(sp.encode_frames(iter(map(to_nchw, frames)), y0))
    ref_encs = list(ref.encode_frames(iter(map(to_nchw, frames)),
                                      ref.analysis(to_nchw(x) * 0.9)))
    for e, ej, er in zip(encs, j_encs, ref_encs):
        _same_streams(e, ej)
        _same_streams(e, er)
    outs = list(sp.decode_frames(iter(encs), y0))
    j_outs = list(jsp.decode_frames(iter(j_encs), jsp.analysis(xj * 0.9)))
    assert all(isinstance(y, Sharded) for _, y in outs)
    np.testing.assert_allclose(to_nhwc(outs[-1][0].gather()),
                               np.asarray(j_outs[-1][0]), atol=1e-5)
    np.testing.assert_allclose(to_nhwc(outs[-1][1].gather()),
                               np.asarray(j_outs[-1][1]), atol=1e-5)


def test_split_and_unsplit_streams_decode_either_way(spatial_serving):
    """TPM, HD and EPM run whole in the W-split pipeline, so a stream
    encoded split decodes through the unsplit pipeline, and one encoded
    unsplit through the split pipeline, to the encoder's ŷ exactly."""
    x, ref, sp, _ = spatial_serving
    frames = [to_nchw(x), to_nchw(np.clip(x * 0.97 + 0.01, 0, 1))]
    y0 = ref.analysis(frames[0] * 0.9)
    for enc_pipe, dec_pipe in ((sp, ref), (ref, sp)):
        y_enc, encs = y0, []
        carries = []
        for f in frames:
            enc, y_enc = enc_pipe.encode_frame(f, y_enc)
            encs.append(enc)
            carries.append(y_enc)
        for (_, y_dec), carry in zip(dec_pipe.decode_frames(encs, y0),
                                     carries):
            assert torch.equal(whole(y_dec), whole(carry))


def test_mesh_axis_names_must_match(spatial_serving):
    """A function given an axis its mesh lacks raises, as a JAX sharding
    naming an axis outside its mesh does."""
    _, ref, _, _ = spatial_serving
    with pytest.raises(ValueError, match="axis"):
        shard_batch(torch.zeros(8, 1), SP8)
    with pytest.raises(ValueError, match="axis"):
        shard_frame(torch.zeros(1, 3, 8, 16), CPU8)
    with pytest.raises(ValueError, match="axis"):
        StemVideoPipeline(ref.i_model, ref.stem, spatial_mesh=CPU8)
    with pytest.raises(ValueError, match="axis"):
        ref.gop_forward_sharded(torch.zeros(1, 8, 3, 64, 64),
                                torch.zeros(8, 16, 4, 4), SP8)


def test_replica_copies_model_and_tables(spatial_serving):
    """mesh.replica: a CompressionModel's copy with its own parameters and
    tables codes as the original does; an nn.Module's copy computes as the
    original does."""
    x, ref, _, _ = spatial_serving
    twin = replica(ref.stem, "cpu")
    assert all(a is not b and torch.equal(a, b) for a, b in zip(
        twin.module.parameters(), ref.stem.module.parameters()))
    y = ref.analysis(to_nchw(x))
    a = ref.stem.fused_encode_sparse_carry_expr(y, 0.9 * y)
    b = twin.fused_encode_sparse_carry_expr(y, 0.9 * y)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    g_a = replica(ref.i_model.module.g_a, "cpu")
    xt = to_nchw(x)
    assert torch.equal(g_a(xt), ref.i_model.module.g_a(xt))


def test_replica_on_follows_its_model():
    """mesh.replica_on: the model itself on its own device; elsewhere one
    copy, kept, whose values follow the model's in-place changes, and which
    is made anew when the compute dtype changes."""
    model = MeanScaleHyperprior(8, 16, device="cpu", seed=7)
    assert replica_on(model, "cpu") is model
    twin = replica_on(model, "cpu:0")
    assert twin is not model and replica_on(model, "cpu:0") is twin
    with torch.no_grad():
        for p in model.module.parameters():
            p.mul_(0.5)
    assert replica_on(model, "cpu:0") is twin
    assert all(torch.equal(a, b) for a, b in zip(
        twin.module.parameters(), model.module.parameters()))
    model.set_compute_dtype(torch.bfloat16)
    again = replica_on(model, "cpu:0")
    assert again is not twin and again.compute_dtype == torch.bfloat16
    x = torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(2))
    assert torch.equal(again.analysis(x), model.analysis(x))
