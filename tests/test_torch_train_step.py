"""The port's training modules against the JAX package's on the CPU: the
train forwards of MeanScaleHyperprior and the five STEM variants, the aux
loss and its gradient, the four losses, the optimizer split and the
plateau schedule, and one and two steps of every train-step function.

Small widths: N = M = 16, EB 16, 64×64 images (4×4 latents). Both packages
get the same fed noise: ``quantize_noise`` is replaced, in each module
that imported it by name, by x + 0.45·sin(7·x + k) with the gradient of
the identity (as real noise has; a steeper function would amplify the
last-bit differences of the two packages' latents), k one per call site (bottleneck,
Gaussian conditional, getY, the STEM context), so the SPM variants' two
draws differ as the two real draws do. The real draw is tested alone.

Tolerances: losses within 1e-4 relative; each gradient leaf within 1e-4
of its max|g| (a first step's clipped gradients, read from the Adam first
moments it leaves); likelihoods within 1e-3 nats; parameters after one
update within 1e-6, except entries where the two packages' gradients give
Adam updates more than 5e-7 apart (the first is lr·g/(|g| + 1e-8) ≈
lr·sign(g): opposite signs of near-zero gradients, or |g| near ε): those
are held within 2·lr and counted. The second update starts from equal
states (the port is synced to the JAX package's parameters and moments):
otherwise the first update's flipped entries move the models apart.
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spatiotemporalentropymodel_tpu.models import (
    MeanScaleHyperprior as JaxMSH,
    STEMModule as JaxSTEM,
)
from spatiotemporalentropymodel_tpu.parallel import train_step as jts
from spatiotemporalentropymodel_tpu.training import losses as jlosses
from spatiotemporalentropymodel_tpu.training import optimizers as jopt
from spatiotemporalentropymodel_tpu_torch.convert import (
    jax_tree, load_jax_params, state_dict_from_jax,
)
from spatiotemporalentropymodel_tpu_torch.models import (
    STEM_VARIANTS, MeanScaleHyperprior, STEMModule,
)
from spatiotemporalentropymodel_tpu_torch.ops.quantize import quantize_noise
from spatiotemporalentropymodel_tpu_torch.parallel import train_step as pts
from spatiotemporalentropymodel_tpu_torch.training import losses as plosses
from spatiotemporalentropymodel_tpu_torch.training import optimizers as popt

from torch_port_util import (  # noqa: F401 (fed_noise: a fixture)
    export_jax_tree, fed_noise, paths as _paths, to_nchw, to_nhwc,
)

N = M = EBC = 16
B, HW, T = 2, 64, 3
LR, AUX_LR, LMBDA = 1e-4, 1e-3, 1e-2
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-4  # × max|g| of the leaf
LOG_LK_ATOL = 1e-3  # nats per element, about 0.0014 bits
PARAM_ATOL = 1e-6

def _port_grads(module, params, grads):
    """Gradients of ``params`` as the JAX tree (``convert.jax_tree`` of a
    copy of ``module`` holding them)."""
    twin = copy.deepcopy(module)
    by_id = {id(p): g for p, g in zip(params, grads)}
    for p, q in zip(module.parameters(), twin.parameters()):
        g = by_id.get(id(p))
        q.data = torch.zeros_like(p) if g is None else g.detach().clone()
    return _paths(jax_tree(twin))


def _assert_grads(port, ref):
    assert port.keys() == ref.keys()
    for key, r in ref.items():
        scale = max(float(np.abs(r).max()), 1e-30)
        err = float(np.abs(port[key] - r).max())
        assert err <= GRAD_TOL * scale, (key, err, scale)


def _adam(g, m, v, t):
    """Adam's update for gradient g on moments (m, v) at step t."""
    m = 0.9 * m + 0.1 * g
    v = 0.999 * v + 0.001 * g * g
    return LR * (m / (1 - 0.9**t)) / (np.sqrt(v / (1 - 0.999**t)) + 1e-8)


def _unpinned(port, ref, moments, t):
    """Per leaf, the entries where the two gradients, though within
    GRAD_TOL, give Adam updates more than PARAM_ATOL/2 apart: opposite signs
    of near-zero gradients, or |g| near Adam's ε (the first step is
    lr·g/(|g| + 1e-8) ≈ lr·sign(g))."""
    return {k: np.abs(_adam(port[k], *moments[k], t)
                      - _adam(g, *moments[k], t)) > PARAM_ATOL / 2
            for k, g in ref.items()}


def _assert_params(port_module, jax_params, unpinned):
    """Parameters after an update from equal states; returns how many
    entries took the 2·lr bound."""
    port = _paths(jax_tree(port_module))
    ref = _paths(jax_params)
    assert port.keys() == ref.keys()
    n = 0
    for key, r in ref.items():
        err = np.abs(port[key] - r)
        mask = unpinned[key]
        assert float(np.where(mask, 0, err).max()) <= PARAM_ATOL, key
        assert float(np.where(mask, err, 0).max()) <= 2 * LR, key
        n += int(mask.sum())
    return n


def _grad(loss, params):
    return torch.autograd.grad(loss, params, allow_unused=True)


def _close(a, b, rtol=LOSS_RTOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=0)


def _close_log(port_lk, ref_lk):
    """Likelihoods as rates: |log p − log p_ref| ≤ LOG_LK_ATOL nats."""
    got = np.log(to_nhwc(port_lk).astype(np.float64))
    want = np.log(np.asarray(ref_lk, np.float64))
    assert float(np.abs(got - want).max()) <= LOG_LK_ATOL


# ---- models ------------------------------------------------------------


@pytest.fixture(scope="module")
def msh():
    """The JAX MSH(16, 16) module, parameters drawn by the port (a JAX
    init costs seconds per op on this CPU) and 64×64 NHWC images."""
    x = np.random.default_rng(0).random((B, HW, HW, 3), dtype=np.float32)
    params = export_jax_tree(MeanScaleHyperprior(N, M, device="cpu").module)
    return JaxMSH(N, M).module, params, x


def _port_msh(params):
    model = MeanScaleHyperprior(N, M, device="cpu")
    load_jax_params(model.module, params)
    return model


@pytest.fixture(scope="module")
def stems():
    """The JAX STEMModule of each variant and parameters drawn by the port."""
    return {v: (JaxSTEM(variant=v, entropy_bottleneck_channels=EBC,
                        in_channels=M),
                export_jax_tree(STEMModule(
                    v, EBC, M, torch.Generator().manual_seed(3))))
            for v in STEM_VARIANTS}


def _port_stem(variant, params):
    module = STEMModule(variant, EBC, M)
    load_jax_params(module, params)
    return module


def _latents(seed=1, t=T):
    """(B, T, 4, 4, M) NHWC latents, frame 0 rounded (the quantized carry)."""
    rng = np.random.default_rng(seed)
    lat = (3.0 * rng.standard_normal((B, t, HW // 16, HW // 16, M))).astype(
        np.float32)
    lat[:, 0] = np.round(lat[:, 0])
    return lat


def _seq_nchw(lat):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(lat, -1, 2)))


# ---- the noise draw itself ---------------------------------------------


def test_quantize_noise_draw():
    """U(−0.5, 0.5) from the caller's generator: range, mean, repeatable
    for a seed, and no draw from the global RNG."""
    x = torch.zeros(200_000)
    torch.manual_seed(5)
    before = torch.get_rng_state()
    a = quantize_noise(x, torch.Generator().manual_seed(7))
    assert torch.equal(torch.get_rng_state(), before)
    b = quantize_noise(x, torch.Generator().manual_seed(7))
    c = quantize_noise(x, torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= -0.5 and float(a.max()) < 0.5
    assert abs(float(a.mean())) < 3 * (1 / math.sqrt(12)) / math.sqrt(
        x.numel())
    assert abs(float(a.var()) - 1 / 12) < 1e-3
    with pytest.raises(ValueError):
        quantize_noise(x, None)


def test_train_forward_draws_from_generator():
    """Train mode draws noise (two calls from one generator differ), and
    the same generator seed repeats the forward exactly."""
    model = MeanScaleHyperprior(N, M, device="cpu")
    x = torch.rand(1, 3, HW, HW, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(3)
    a, b = (model.forward(x, train=True, generator=g) for _ in range(2))
    c = model.forward(x, train=True,
                      generator=torch.Generator().manual_seed(3))
    assert not torch.equal(a["y_hat"], b["y_hat"])
    assert torch.equal(a["y_hat"], c["y_hat"])
    frac = float((a["y_hat"] - a["y"]).abs().max().detach())
    assert 0 < frac <= 0.5


# ---- train forwards ----------------------------------------------------


def test_msh_train_forward(fed_noise, msh):
    module, params, x = msh
    ref = module.apply({"params": params}, jnp.asarray(x), train=True,
                       rngs={"noise": jax.random.PRNGKey(0)})
    port = _port_msh(params)
    out = port.forward(to_nchw(x), train=True,
                       generator=torch.Generator().manual_seed(0))
    for name in ("y", "z"):
        _close_log(out["likelihoods"][name], ref["likelihoods"][name])
    np.testing.assert_allclose(to_nhwc(out["y_hat"]), ref["y_hat"],
                               atol=1e-4)
    np.testing.assert_allclose(to_nhwc(out["x_hat"]), ref["x_hat"],
                               atol=1e-4)
    y, y_q = port.module.get_y(to_nchw(x), train=True,
                               generator=torch.Generator())
    ry, ry_q = module.apply({"params": params}, jnp.asarray(x), train=True,
                            method="get_y",
                            rngs={"noise": jax.random.PRNGKey(0)})
    np.testing.assert_allclose(to_nhwc(y_q), ry_q, atol=1e-4)
    assert not np.allclose(ry_q, np.round(ry_q))


@pytest.mark.parametrize("variant", STEM_VARIANTS)
def test_stem_train_forward(fed_noise, stems, variant):
    module, params = stems[variant]
    lat = _latents()
    ref = module.apply({"params": params}, jnp.asarray(lat[:, 1]),
                       jnp.asarray(lat[:, 0]), train=True,
                       rngs={"noise": jax.random.PRNGKey(0)})
    port = _port_stem(variant, params)
    seq = _seq_nchw(lat)
    out = port(seq[:, 1], seq[:, 0], train=True,
               generator=torch.Generator())
    for name in ("y", "z"):
        _close_log(out["likelihoods"][name], ref["likelihoods"][name])
    np.testing.assert_allclose(to_nhwc(out["y_hat"]), ref["y_hat"],
                               atol=1e-5)
    # noise, not rounding: ŷ is off the integer grid
    target = lat[:, 1] - lat[:, 0] if variant == "res" else lat[:, 1]
    y_q = np.asarray(ref["y_hat"]) - (lat[:, 0] if variant == "res" else 0)
    assert np.abs(y_q - np.round(target)).max() > 0.1


# ---- aux loss, losses, optimizers ----------------------------------------


def test_aux_loss_and_its_gradient(msh):
    module, params, _ = msh
    ref, g_ref = jax.value_and_grad(
        lambda p: module.apply({"params": p}, method="aux_loss"))(params)
    port = _port_msh(params)
    aux = port.aux_loss()
    _close(aux.detach(), ref)
    names = [n for n, _ in port.module.named_parameters()]
    grads = torch.autograd.grad(aux, list(port.module.parameters()),
                                allow_unused=True)
    got = {n for n, g in zip(names, grads) if g is not None}
    assert got == {"entropy_bottleneck.quantiles"}
    port_g = _port_grads(port.module, list(port.module.parameters()), grads)
    ref_g = _paths(g_ref)
    for key, r in ref_g.items():
        if key[-1] != "quantiles":
            assert not np.any(r), key
    _assert_grads(port_g, ref_g)


def test_losses_match_jax():
    rng = np.random.default_rng(4)
    lk = {k: rng.uniform(1e-6, 1, (B, 4, 4, M)).astype(np.float32)
          for k in ("y", "z")}
    x = rng.random((B, 16, 16, 3), dtype=np.float32)
    x_hat = rng.random((B, 16, 16, 3), dtype=np.float32)
    qmap = rng.random((B, 16, 16, 1), dtype=np.float32)
    lat = rng.standard_normal((B, 4, 4, M)).astype(np.float32)
    j_out = {"x_hat": jnp.asarray(x_hat),
             "likelihoods": {k: jnp.asarray(v) for k, v in lk.items()}}
    p_out = {"x_hat": to_nchw(x_hat),
             "likelihoods": {k: to_nchw(v) for k, v in lk.items()}}
    pairs = [
        (jlosses.em_loss(j_out, jnp.asarray(lat)),
         plosses.em_loss(p_out, to_nchw(lat))),
        (jlosses.em_loss(j_out, jnp.asarray(x), upscale=1),
         plosses.em_loss(p_out, to_nchw(x), upscale=1)),
        (jlosses.rate_distortion_loss(j_out, jnp.asarray(x), 0.0483),
         plosses.rate_distortion_loss(p_out, to_nchw(x), 0.0483)),
        (jlosses.pixelwise_rate_distortion_loss(
            j_out, jnp.asarray(x), jlosses.quality2lambda(jnp.asarray(qmap))),
         plosses.pixelwise_rate_distortion_loss(
             p_out, to_nchw(x), plosses.quality2lambda(to_nchw(qmap)))),
    ]
    for ref, got in pairs:
        assert ref.keys() == got.keys()
        for k in ref:
            _close(got[k], ref[k])
    _close(plosses.quality2lambda(torch.from_numpy(qmap)),
           jlosses.quality2lambda(jnp.asarray(qmap)))


@pytest.mark.parametrize("scale", [0.3, 1.0, 2.0], ids=["below", "at",
                                                         "above"])
def test_clip_matches_optax(scale):
    """The global-norm clip against optax.clip_by_global_norm, below, at
    (optax clips at norm ≥ max) and above the threshold."""
    rng = np.random.default_rng(2)
    gs = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    norm = math.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in gs))
    gs = [(g / norm * scale).astype(np.float32) for g in gs]
    max_norm = float(np.sqrt(sum((g.astype(np.float32) ** 2).sum()
                                 for g in gs))) if scale == 1.0 else 1.0
    ref, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in gs], optax.EmptyState())
    port = [torch.from_numpy(g.copy()) for g in gs]
    popt.clip_by_global_norm(port, max_norm)
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-6)
    if scale < 1:
        for p, g in zip(port, gs):
            assert np.array_equal(p.numpy(), g)


def test_optimizer_split(stems):
    """Main Adam over every parameter but quantiles, aux over quantiles
    only, as the JAX masks; the clip's norm is the main gradients'."""
    module, params = stems["res"]
    port = _port_stem("res", params)
    pair = popt.configure_optimizers(port, LR, AUX_LR, 1.0)
    names = {id(p): n for n, p in port.named_parameters()}
    main = {names[id(p)] for p in pair.main.param_groups[0]["params"]}
    aux = {names[id(p)] for p in pair.aux.param_groups[0]["params"]}
    mask = _paths(jopt.quantiles_mask(params))
    assert aux == {"entropy_bottleneck.quantiles"}
    assert {k for k, m in mask.items() if m} == {
        ("entropy_bottleneck", "quantiles")}
    assert main | aux == set(names.values()) and not main & aux
    assert pair.main.param_groups[0]["lr"] == LR
    assert pair.aux.param_groups[0]["lr"] == AUX_LR
    popt.set_main_learning_rate(pair.main, 5e-5)
    assert popt.get_main_learning_rate(pair.main) == 5e-5


def test_plateau_schedule_state_dict():
    """The plateau schedule steps as the JAX package's and its state_dict
    round-trips into a fresh one that goes on identically."""
    metrics = [1.0, 0.9, 0.95, 0.95, 0.95, 0.5, 0.6, 0.6, 0.6, 0.6]
    ref = jopt.ReduceLROnPlateau(factor=0.5, patience=2)
    port = popt.ReduceLROnPlateau(factor=0.5, patience=2)
    for i, m in enumerate(metrics):
        assert port.step(m) == ref.step(m)
        assert port.state_dict() == ref.state_dict()
        if i == 4:
            resumed = popt.ReduceLROnPlateau(factor=0.5, patience=2)
            resumed.load_state_dict(port.state_dict())
    resumed_scales = [resumed.step(m) for m in metrics[5:]]
    fresh = popt.ReduceLROnPlateau(factor=0.5, patience=2)
    scales = [fresh.step(m) for m in metrics]
    assert resumed_scales == scales[5:]
    avg = popt.MovingAverage(3)
    assert [avg.next(v) for v in (1, 2, 3, 4)] == [1, 1.5, 2, 3]


# ---- train steps ---------------------------------------------------------


def _jax_pair(params):
    opt = jopt.configure_optimizers(params, LR, AUX_LR, 1.0)
    return opt, jts.init_train_state(params, opt)


def _port_pair(module):
    opt = popt.configure_optimizers(module, LR, AUX_LR, 1.0)
    return opt, pts.init_train_state(module, opt)


def _adam_states(opt_state):
    return [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]


def _jax_moments(state):
    """{JAX path: (μ, ν)} of both Adams (masked leaves are absent)."""
    out = {}
    for opt_state in (state.main_opt_state, state.aux_opt_state):
        (adam,) = _adam_states(opt_state)
        nu = _paths(adam.nu)
        out.update({k: (m, nu[k]) for k, m in _paths(adam.mu).items()})
    return out


def _port_moments(pstate):
    module, opts = pstate.module, pstate.optimizers
    params = list(module.parameters())
    mom = [next((opt.state[p]["exp_avg"], opt.state[p]["exp_avg_sq"])
                for opt in opts[:2] if p in opt.state) for p in params]
    mu = _port_grads(module, params, [m for m, _ in mom])
    nu = _port_grads(module, params, [v for _, v in mom])
    return {k: (m, nu[k]) for k, m in mu.items()}


def _sync_port(pstate, jax_state):
    """The port's parameters and Adam moments set to the JAX package's, so
    the next update starts from equal states."""
    module = pstate.module
    load_jax_params(module, jax_state.params)
    tree = {}
    for k, (m, v) in _jax_moments(jax_state).items():
        node = tree
        for key in k[:-1]:
            node = node.setdefault(key, {})
        node[k[-1]] = (m, v)
    mus = state_dict_from_jax(module, jax.tree_util.tree_map(
        lambda mv: mv[0], tree, is_leaf=lambda n: isinstance(n, tuple)))
    nus = state_dict_from_jax(module, jax.tree_util.tree_map(
        lambda mv: mv[1], tree, is_leaf=lambda n: isinstance(n, tuple)))
    for name, p in module.named_parameters():
        opt = next(o for o in pstate.optimizers[:2] if p in o.state)
        opt.state[p]["exp_avg"].copy_(mus[name])
        opt.state[p]["exp_avg_sq"].copy_(nus[name])


def _run_steps(jax_step, port_step, jax_state, port_state, jax_args,
               port_args, port_module, steps=2):
    """``steps`` updates on both sides, each from equal states (the port is
    synced to the JAX package after each): per update the metrics, the
    gradients (from the moments it leaves: g = (μ' − 0.9·μ)/0.1) and the
    parameters. Returns per update how many entries took the 2·lr bound."""
    counts = []
    for t in range(1, steps + 1):
        before = _jax_moments(jax_state) if t > 1 else None
        jax_state, metrics = jax_step(jax_state, *jax_args(t))[:2]
        port_state, pmetrics = port_step(port_state, *port_args(t))[:2]
        assert metrics.keys() == pmetrics.keys()
        for k in metrics:
            _close(pmetrics[k], metrics[k])
        assert port_state.step == int(jax_state.step) == t
        after_j, after_p = _jax_moments(jax_state), _port_moments(port_state)
        m0 = before or {k: (0 * m, 0 * v) for k, (m, v) in after_j.items()}
        g_ref = {k: (after_j[k][0] - 0.9 * m0[k][0]) / 0.1 for k in after_j}
        g_port = {k: (after_p[k][0] - 0.9 * m0[k][0]) / 0.1 for k in after_j}
        _assert_grads(g_port, g_ref)
        counts.append(_assert_params(
            port_module, jax_state.params,
            _unpinned(g_port, g_ref, m0, t)))
        _sync_port(port_state, jax_state)
    return counts


def test_image_train_step(fed_noise, msh):
    """make_image_train_step, one and two updates."""
    module, params, x = msh
    port = _port_msh(params).module
    opt, state = _jax_pair(params)
    popt_, pstate = _port_pair(port)
    gen = torch.Generator()
    counts = _run_steps(
        jax.jit(jts.make_image_train_step(module, opt, LMBDA)),
        pts.make_image_train_step(port, popt_, LMBDA), state, pstate,
        lambda i: (jnp.asarray(x), jax.random.PRNGKey(i)),
        lambda i: (to_nchw(x), gen), port)
    print(f"image steps: {counts} entries not pinned by the gradients")


def test_stem_train_step(fed_noise, stems):
    """make_stem_train_step (per_sequence) on a 3-frame res sequence, one
    and two updates."""
    module, params = stems["res"]
    lat = _latents()
    port = _port_stem("res", params)
    opt, state = _jax_pair(params)
    popt_, pstate = _port_pair(port)
    gen = torch.Generator()
    counts = _run_steps(
        jax.jit(jts.make_stem_train_step(module, opt)),
        pts.make_stem_train_step(port, popt_), state, pstate,
        lambda i: (jnp.asarray(lat), jax.random.PRNGKey(i)),
        lambda i: (_seq_nchw(lat), gen), port)
    print(f"stem sequence steps: {counts} entries not pinned by the gradients")


@pytest.mark.parametrize("variant", ["without_spm", "full"])
def test_stem_frame_step(fed_noise, stems, variant):
    """make_stem_frame_step (per_frame): two P-frames, one update each,
    ŷ carried (detached) from the first to the second."""
    module, params = stems[variant]
    lat = _latents(2)
    latj, seq = jnp.asarray(lat), _seq_nchw(lat)
    port = _port_stem(variant, params)
    opt, state = _jax_pair(params)
    popt_, pstate = _port_pair(port)
    jax_step = jax.jit(jts.make_stem_frame_step(module, opt))
    port_step = pts.make_stem_frame_step(port, popt_)
    gen = torch.Generator()
    carry = {"jax": latj[:, 0], "port": seq[:, 0]}

    def jax_stepped(st, t, key):
        st, metrics, carry["jax"] = jax_step(st, latj[:, t], carry["jax"],
                                             key)
        return st, metrics

    def port_stepped(st, t):
        st, metrics, carry["port"] = port_step(st, seq[:, t], carry["port"],
                                               gen)
        assert not carry["port"].requires_grad
        np.testing.assert_allclose(to_nhwc(carry["port"]), carry["jax"],
                                   atol=1e-4)
        carry["port"] = to_nchw(carry["jax"])  # equal states for the next
        return st, metrics

    counts = _run_steps(
        jax_stepped, port_stepped, state, pstate,
        lambda i: (i, jax.random.PRNGKey(i)), lambda i: (i,), port)
    print(f"stem frame steps ({variant}): {counts} entries not pinned by "
          f"the gradients")


@pytest.mark.parametrize("variant", ["without_spm_tpm", "res"])
def test_stem_eval_step(stems, variant):
    module, params = stems[variant]
    lat = _latents(3, t=4)
    ref = jts.make_stem_eval_step(module)(params, jnp.asarray(lat))
    got = pts.make_stem_eval_step(_port_stem(variant, params))(_seq_nchw(lat))
    _close(got, ref)


@pytest.mark.parametrize("variant", ["without_spm", "res"])
def test_carry_is_detached(fed_noise, stems, variant):
    """The carry reaches no parameter: a train forward's ŷ is the target
    plus noise (plus y_cond for res), so it has no graph, and the sequence
    loss's gradient is that of its frames each conditioned on a constant
    carry computed apart. The per-frame step hands back ŷ detached."""
    _, params = stems[variant]
    port = _port_stem(variant, params)
    params_p = list(port.parameters())
    seq = _seq_nchw(_latents(4))
    got = _grad(pts.sequence_loss(port, seq, torch.Generator())["loss"],
                params_p)
    y_cond, losses = seq[:, 0], []
    for t in (1, 2):
        out = port(seq[:, t], y_cond, train=True, generator=torch.Generator())
        assert out["y_hat"].grad_fn is None and not out["y_hat"].requires_grad
        losses.append(plosses.em_loss(out, seq[:, t])["loss"])
        y_cond = out["y_hat"]
    want = _grad(torch.stack(losses).mean(), params_p)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            torch.testing.assert_close(g, w, rtol=0, atol=0)
