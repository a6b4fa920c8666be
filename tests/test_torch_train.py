"""The port's training step (``hvi_cidnet_torch/train``) vs the JAX
package's (CPU, fp32, the tiny CIDNet: channels 8/8/16/32, 2 x 32 x 32).

Adam amplifies tiny gradient differences (its first steps are about
lr * sign(g)), so the parts are held separately, each at a bar set before
the first run:

* the schedule, bitwise (``==`` on python floats), every branch;
* ``composite_loss``'s value and every parameter's gradient against
  ``jax.value_and_grad(composite_loss)``: base with gamma and the
  perceptual term, and TNSM with its noise terms. Per tensor, the largest
  difference within TOL_GRAD (base) or TOL_GRAD_TNSM times that tensor's
  largest |gradient|; a tensor whose JAX gradient is zero must be zero;
* the optimizer fed the JAX gradients, against optax's update for the
  three clip modes: within 1e-5 lr + 2 fp32 ulps of the parameter;
* two end-to-end steps, and one step after a checkpoint crosses stacks
  either way, against the other stack's step: in units of lr (LR_BARS);
* ``grad_accum 2`` against the full batch, ``remat`` against none
  (bitwise on the CPU), the indivisible-batch error, the guard, the lr,
  the ``opt::`` leaf order (derived here from the JAX optimizer state) and
  the kernels' launches per step.

The JAX side is three jitted programs (base and TNSM ``value_and_grad``,
one ``make_train_step``); the rest runs eager.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvi_cidnet_tpu.models.cidnet import CIDNetConfig as JaxConfig
from hvi_cidnet_tpu.train import checkpoint as jax_ckpt
from hvi_cidnet_tpu.train import schedule as jax_schedule
from hvi_cidnet_tpu.train import trainer as jt
from hvi_cidnet_torch.compat.jax_params import jax_params_to_torch, load_weights, torch_to_jax_params
from hvi_cidnet_torch.losses.vgg import VGG19, VGGFeatures, vgg_params_from_jax
from hvi_cidnet_torch.models import cidnet as cidnet_mod
from hvi_cidnet_torch.models import layers, tnsm
from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig
from hvi_cidnet_torch.train import checkpoint as ckpt
from hvi_cidnet_torch.train import schedule
from hvi_cidnet_torch.train import trainer as pt
from _torch_port import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(channels=(8, 8, 16, 32), heads=(1, 2, 4, 8))
LR = 1e-3
GAMMA = 0.8
TOL_LOSS, TOL_LOSS_TNSM = 1e-5, 1e-4       # composite loss, relative
TOL_GRAD, TOL_GRAD_TNSM = 1e-4, 1e-3       # per tensor, of its largest |gradient|
TOL_OPT_LR = 1e-5                          # optimizer on equal gradients, x lr
EPS32 = float(np.finfo(np.float32).eps)
# parameters after steps of the two stacks, in units of lr: the mean |diff|,
# the share of elements past 0.1 lr, and the largest (Adam's update is about
# lr * sign(g): a near-zero gradient whose sign differs moves up to 2 lr)
LR_BARS = {"mean": 1e-3, "share_past_0.1": 1e-2, "max_per_step": 2.0}


def _jcfg(variant="base", **kw):
    return jt.TrainConfig(model=JaxConfig(variant=variant, **TINY), compute_dtype="float32",
                          lr=LR, **kw)


def _pcfg(variant="base", **kw):
    kw = {"compute_dtype": "float32", **kw}
    return pt.TrainConfig(model=CIDNetConfig(variant=variant, **TINY), lr=LR, **kw)


def _batch(seed, n=2, hw=32):
    rng = np.random.default_rng(seed)
    low = rng.uniform(0, 0.3, (n, hw, hw, 3)).astype(np.float32)
    high = np.clip(low * 3 + rng.normal(0, 0.05, low.shape), 0, 1).astype(np.float32)
    return low, high


def _model(variant="base", seed=0) -> CIDNet:
    return CIDNet(CIDNetConfig(variant=variant, **TINY), generator=torch.Generator().manual_seed(seed))


def _jax_params(model: CIDNet) -> dict:
    return {k: jnp.asarray(v) for k, v in torch_to_jax_params(model.state_dict()).items()}


def _np(tree: dict) -> dict:
    """Host copies (the JAX train step donates its inputs' buffers, which a
    zero-copy view would share)."""
    return {k: np.array(v) for k, v in tree.items()}


def _port_grads(model: CIDNet) -> dict:
    """The model's gradients in the JAX layout (None -> zeros)."""
    return torch_to_jax_params({n: p.grad if p.grad is not None else torch.zeros_like(p)
                                for n, p in model.named_parameters()})


@pytest.fixture(scope="module")
def vgg():
    """A VGG19 up to conv4_4 on both sides, from one numpy draw (HWIO)."""
    rng = np.random.default_rng(0)
    params, cin = {}, 3
    for name, kind, cout in VGG19[:26]:
        if kind == "conv":
            params[name + ".weight"] = rng.normal(0, np.sqrt(2 / (9 * cin)), (3, 3, cin, cout)).astype(np.float32)
            params[name + ".bias"] = np.zeros(cout, np.float32)
            cin = cout
    port = VGGFeatures()
    port.load_state_dict(vgg_params_from_jax(params), strict=True)
    return {k: jnp.asarray(v) for k, v in params.items()}, port.eval().requires_grad_(False)


# --------------------------------------------------------------------------
# the schedule
# --------------------------------------------------------------------------


@pytest.mark.parametrize("cyclic", [False, True])
@pytest.mark.parametrize("warmup", [False, True])
@pytest.mark.parametrize("start_epoch", [0, 7])
def test_schedule_bitwise(cyclic, warmup, start_epoch):
    for n in (40, 1000):
        kw = dict(start_epoch=start_epoch, warmup_epochs=3, start_warmup=warmup,
                  cos_restart=True, cos_restart_cyclic=cyclic)
        ours = schedule.build_reference_schedule(1e-4, n, **kw)
        ref = jax_schedule.build_reference_schedule(1e-4, n, **kw)
        assert [ours(e) for e in range(n + 2)] == [ref(e) for e in range(n + 2)]


def test_schedule_pieces_bitwise():
    for periods, weights, etas in (([30], [1], [1e-7]), ([10, 30], [1, 1], [2e-4, 1e-7])):
        ours = schedule.cosine_restart(2e-4, periods, weights, etas)
        ref = jax_schedule.cosine_restart(2e-4, periods, weights, etas)
        assert [ours(e) for e in range(45)] == [ref(e) for e in range(45)]
    for mult in (1.0, 2.0):
        ours = schedule.gradual_warmup(1e-4, 3, lambda e: 0.5 * e, mult)
        ref = jax_schedule.gradual_warmup(1e-4, 3, lambda e: 0.5 * e, mult)
        assert [ours(e) for e in range(8)] == [ref(e) for e in range(8)]
    assert schedule.gradual_warmup(1e-4, 3, lambda e: 1.0)(0) == 0.0  # epoch 1 trains at lr 0
    with pytest.raises(ValueError, match="choose a scheduler"):
        schedule.build_reference_schedule(1e-4, 10, cos_restart=False)


# --------------------------------------------------------------------------
# composite_loss: value and gradients
# --------------------------------------------------------------------------

CASES = {
    "base": dict(variant="base", gamma_aug=True, use_perceptual=True),
    "tnsm": dict(variant="tnsm", use_perceptual=False),
}


# XLA's CPU backend at its lowest optimisation level: a third less compile
# time for these one-shot programs, and the same function
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module")
def jax_grads(vgg):
    """case -> the JAX ``value_and_grad(composite_loss)`` of (params, low,
    high, gamma), compiled once (the file's two JAX programs)."""
    jvgg, _ = vgg
    lowered = {}
    for case, kw in CASES.items():
        kw = dict(kw)
        variant = kw.pop("variant")
        cfg = _jcfg(variant, **kw)
        v = jvgg if cfg.use_perceptual else None
        fn = jax.jit(jax.value_and_grad(
            lambda p, lo, hi, g, cfg=cfg, v=v: jt.composite_loss(p, lo, hi, g, v, cfg)[0]))
        low, high = (jnp.asarray(t) for t in _batch(0))
        lowered[case] = fn.lower(_jax_params(_model(variant)), low, high, jnp.float32(GAMMA))
    # XLA compiles outside the GIL: both programs at once
    with ThreadPoolExecutor(len(lowered)) as pool:
        compiled = dict(zip(lowered, pool.map(
            lambda lo: lo.compile(compiler_options=FAST_COMPILE), lowered.values())))
    return {case: (lambda p, lo, hi, c=c: c(p, jnp.asarray(lo), jnp.asarray(hi),
                                            jnp.float32(GAMMA)))
            for case, c in compiled.items()}


@pytest.fixture(scope="module")
def loss_refs(jax_grads):
    """case -> (port model, batch, JAX loss, JAX gradients)."""
    out = {}
    for case, kw in CASES.items():
        model = _model(kw["variant"], seed=1)
        low, high = _batch(2)
        loss, grads = jax_grads[case](_jax_params(model), low, high)
        out[case] = (model, (low, high), float(loss), _np(grads))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_composite_loss_and_gradients_match_jax(loss_refs, vgg, case):
    model, (low, high), ref_loss, ref_grads = loss_refs[case]
    kw = dict(CASES[case])
    variant = kw.pop("variant")
    cfg = _pcfg(variant, **kw)
    loss, aux = pt.composite_loss(model, torch.from_numpy(low), torch.from_numpy(high), GAMMA,
                                  vgg[1] if cfg.use_perceptual else None, cfg)
    model.zero_grad(set_to_none=True)
    loss.backward()
    tol_loss, tol_grad = (TOL_LOSS_TNSM, TOL_GRAD_TNSM) if case == "tnsm" else (TOL_LOSS, TOL_GRAD)
    assert abs(loss.item() - ref_loss) <= tol_loss * abs(ref_loss)
    assert aux["output_rgb"].dtype == torch.float32 and aux["output_rgb"].shape == low.shape
    got = _port_grads(model)
    assert set(got) == set(ref_grads)
    worst = {}
    for name, ref in ref_grads.items():
        scale = np.abs(ref).max()
        if scale == 0:
            assert np.abs(got[name]).max() == 0, name
            continue
        worst[name] = np.abs(got[name] - ref).max() / scale
    assert max(worst.values()) <= tol_grad, sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    assert abs(ref_grads["trans.density_k"][0]) > 0  # k gets its gradient


# --------------------------------------------------------------------------
# the optimizer on the JAX gradients
# --------------------------------------------------------------------------


def _flat(tree: dict) -> np.ndarray:
    return np.concatenate([np.asarray(tree[k]).ravel() for k in sorted(tree)])


@pytest.mark.parametrize("mode,scale", [("faithful", 1.0), ("none", 1.0), ("clip", 1.0),
                                        ("clip", 1e-4)], ids=["faithful", "none", "clip",
                                                              "clip_under_bound"])
def test_optimizer_on_jax_gradients_matches_optax(loss_refs, mode, scale):
    """optax runs eager on the parameters and gradients flattened into one
    vector (Adam is elementwise and the clip's norm is over all gradients
    together, so this is the per-tensor update; one vector keeps eager
    dispatch to a few shapes)."""
    model, _, _, g1 = loss_refs["base"]
    rng = np.random.default_rng(3)
    g1 = {k: (v * scale).astype(np.float32) for k, v in g1.items()}
    g2 = {k: (v * rng.uniform(-1.5, 1.5, v.shape)).astype(np.float32) for k, v in g1.items()}
    params0 = _np(_jax_params(model))
    opt = jt.make_optimizer(_jcfg(grad_clip_mode=mode))
    params = {"flat": jnp.asarray(_flat(params0))}
    state = opt.init(params)
    for g in (g1, g2):
        updates, state = opt.update({"flat": jnp.asarray(_flat(g))}, state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
    # the port
    port = _model("base")
    load_weights(port, jax_params_to_torch(params0))
    popt = pt.make_optimizer(port, _pcfg(grad_clip_mode=mode))
    for g in (g1, g2):
        grads = jax_params_to_torch(g)
        for n, p in port.named_parameters():
            p.grad.copy_(grads[n])
        if mode == "clip":
            pt.clip_by_global_norm_(p.grad for p in port.parameters())
        popt.step()
    got, ref = _flat(torch_to_jax_params(port.state_dict())), np.asarray(params["flat"])
    assert (np.abs(got - ref) <= TOL_OPT_LR * LR + 2 * EPS32 * np.abs(ref)).all()
    # the counts, lr and moments, read out in the JAX state's leaf order
    leaves = ckpt.optimizer_leaves(port, popt)
    ref_leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]
    assert all(np.array_equal(a, b) for a, b in zip(leaves[:7], ref_leaves[:7])), leaves[:7]
    n = len(params0)
    for got, ref in ((leaves[7:7 + n], ref_leaves[7]), (leaves[7 + n:], ref_leaves[8])):
        got = np.concatenate([x.ravel() for x in got])
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_clip_keeps_gradients_under_the_bound_bitwise():
    grads = [torch.full((3,), 1e-3), torch.full((2, 2), -2e-3)]
    before = [g.clone() for g in grads]
    pt.clip_by_global_norm_(grads)
    assert all(torch.equal(a, b) for a, b in zip(grads, before))
    big = [torch.full((4,), 1.0)]
    pt.clip_by_global_norm_(big)
    assert torch.allclose(big[0], torch.full((4,), 0.005), rtol=1e-6, atol=0)


def test_unknown_clip_mode_raises():
    with pytest.raises(ValueError, match="grad_clip_mode"):
        pt.make_optimizer(_model(), _pcfg(grad_clip_mode="norm"))


def test_set_learning_rate_holds_the_jax_float32():
    model = _model()
    popt = pt.make_optimizer(model, _pcfg())
    state = jt.make_optimizer(_jcfg()).init({"flat": jnp.zeros(3)})
    for lr in (1e-4, 1e-4 / 3, 5.00050000125e-05, 0.0):
        pt.set_learning_rate(popt, lr)
        ref = np.asarray(jax.tree_util.tree_leaves(jt.set_learning_rate(state, lr))[5])
        assert ckpt.optimizer_leaves(model, popt)[5] == ref
        assert all(g["lr"] == float(ref) for g in popt.param_groups)


# --------------------------------------------------------------------------
# end to end, and checkpoints across stacks
# --------------------------------------------------------------------------


def _lr_units(got: dict, ref: dict, steps: int) -> None:
    diff = np.concatenate([np.abs(got[k] - ref[k]).ravel() for k in ref]) / LR
    assert diff.mean() <= LR_BARS["mean"], diff.mean()
    assert (diff > 0.1).mean() <= LR_BARS["share_past_0.1"], (diff > 0.1).mean()
    assert diff.max() <= LR_BARS["max_per_step"] * steps, diff.max()


class JaxStep:
    """The JAX train step's function (``make_train_step`` without a mesh or
    accumulation): the compiled ``value_and_grad(composite_loss)``, then
    optax's update and ``apply_updates``, run eager on the parameters
    flattened into one vector (sorted names, as the state's leaves are)."""

    def __init__(self, grad_fn, params: dict, state_tree=None):
        self.grad_fn = grad_fn
        self.names = sorted(params)
        self.shapes = [np.shape(params[n]) for n in self.names]
        self.opt = jt.make_optimizer(_jcfg())
        self.flat = {"flat": jnp.asarray(_flat(params))}
        self.state = self.opt.init(self.flat)
        if state_tree is not None:
            leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(state_tree)]
            n = len(self.names)
            flat_leaves = leaves[:7] + [np.concatenate([x.ravel() for x in leaves[7:7 + n]]),
                                        np.concatenate([x.ravel() for x in leaves[7 + n:]])]
            treedef = jax.tree_util.tree_structure(self.state)
            self.state = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(x) for x in flat_leaves])

    def _split(self, flat: np.ndarray) -> dict:
        out, i = {}, 0
        for n, shape in zip(self.names, self.shapes):
            size = int(np.prod(shape))
            out[n] = flat[i:i + size].reshape(shape)
            i += size
        return out

    def params(self) -> dict:
        return self._split(np.array(self.flat["flat"]))

    def state_tree(self):
        """The state as the JAX trainer holds it (per-parameter moments)."""
        leaves = [np.array(x) for x in jax.tree_util.tree_leaves(self.state)]
        moments = [a for flat in leaves[7:] for a in self._split(flat).values()]
        template = self.opt.init({n: jnp.zeros(s) for n, s in zip(self.names, self.shapes)})
        return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(template),
                                            leaves[:7] + moments)

    def step(self, batch) -> float:
        loss, grads = self.grad_fn(self.params(), *batch)
        updates, self.state = self.opt.update({"flat": jnp.asarray(_flat(_np(grads)))},
                                              self.state, self.flat)
        self.flat = {"flat": self.flat["flat"] + updates["flat"]}
        return float(loss)


@pytest.fixture(scope="module")
def runs(jax_grads, vgg, tmp_path_factory):
    return cross_stack_runs(jax_grads["base"], vgg[1], tmp_path_factory.mktemp("ckpt"))


def cross_stack_runs(grad_fn, port_vgg, tmp):
    """Three steps in each stack (base, gamma and the perceptual term) from
    the same weights on the same batches, a checkpoint of each after two
    (the JAX one by the JAX package's ``save_checkpoint``), and one step of
    each stack from the other's checkpoint."""
    batches = [_batch(10 + i) for i in range(3)]
    model = _model("base", seed=4)
    params0 = _np(_jax_params(model))
    out = {"jax": [], "port": []}
    ref = JaxStep(grad_fn, params0)
    for i, b in enumerate(batches):
        loss = ref.step(b)
        out["jax"].append((ref.params(), loss))
        if i == 1:
            state = ref.state_tree()
            jax_ckpt.save_checkpoint(str(tmp / "jax.npz"), ref.params(), state, epoch=2)
            out["jax_leaves"] = [np.array(x) for x in jax.tree_util.tree_leaves(state)]

    cfg = _pcfg(**{k: v for k, v in CASES["base"].items() if k != "variant"})
    popt = pt.make_optimizer(model, cfg)
    for i, (lo, hi) in enumerate(batches):
        loss, _ = pt.train_step(model, popt, torch.from_numpy(lo), torch.from_numpy(hi), GAMMA,
                                port_vgg, cfg)
        out["port"].append((torch_to_jax_params(model.state_dict()), loss.item()))
        if i == 1:
            ckpt.save_checkpoint(str(tmp / "port.npz"), model, popt, epoch=2)
            out["port_leaves"] = ckpt.optimizer_leaves(model, popt)

    # the port resumes the JAX file; JAX resumes the port's
    resumed = _model("base", seed=9)
    ropt = pt.make_optimizer(resumed, cfg)
    out["port_epoch"] = ckpt.load_checkpoint(str(tmp / "jax.npz"), resumed, ropt)
    out["port_loaded"] = (torch_to_jax_params(resumed.state_dict()),
                          ckpt.optimizer_leaves(resumed, ropt))
    lo, hi = batches[2]
    pt.train_step(resumed, ropt, torch.from_numpy(lo), torch.from_numpy(hi), GAMMA, port_vgg, cfg)
    out["port_from_jax"] = torch_to_jax_params(resumed.state_dict())

    template = jt.make_optimizer(_jcfg()).init({k: jnp.zeros(v.shape) for k, v in params0.items()})
    jparams, jstate, jepoch = jax_ckpt.load_checkpoint(str(tmp / "port.npz"),
                                                       opt_state_template=template)
    out["jax_epoch"] = jepoch
    out["jax_loaded"] = (_np(jparams), [np.array(x) for x in jax.tree_util.tree_leaves(jstate)])
    resumed_ref = JaxStep(grad_fn, _np(jparams), jstate)
    resumed_ref.step(batches[2])
    out["jax_from_port"] = resumed_ref.params()
    return out


def test_two_steps_end_to_end_match_jax(runs):
    for (jp, jl), (pp, pl) in zip(runs["jax"][:2], runs["port"][:2]):
        assert abs(pl - jl) <= TOL_LOSS * abs(jl)
    _lr_units(runs["port"][1][0], runs["jax"][1][0], steps=2)


def _equal_trees(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_port_resumes_a_jax_checkpoint(runs):
    params, leaves = runs["port_loaded"]
    assert runs["port_epoch"] == 2
    _equal_trees(params, runs["jax"][1][0])  # bitwise, as written
    assert len(leaves) == len(runs["jax_leaves"])
    assert all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(leaves, runs["jax_leaves"]))
    _lr_units(runs["port_from_jax"], runs["jax"][2][0], steps=1)


def test_jax_resumes_a_port_checkpoint(runs):
    params, leaves = runs["jax_loaded"]
    assert runs["jax_epoch"] == 2
    _equal_trees(params, runs["port"][1][0])
    assert all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(leaves, runs["port_leaves"]))
    _lr_units(runs["jax_from_port"], runs["port"][2][0], steps=1)


@pytest.mark.parametrize("mode", ["faithful", "clip"])
def test_opt_leaf_order_is_the_jax_state_order(mode):
    """Derived from the JAX optimizer state's flatten paths (``opt::<i>``)."""
    params = _jax_params(_model())
    state = jt.make_optimizer(_jcfg(grad_clip_mode=mode)).init(params)
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(state)[0]]
    stage = "[1]" if mode == "clip" else "[0]"

    def name(path):
        path = path[len(stage):]
        if path == ".count":
            return "count"
        if path.startswith(".hyperparams["):
            return "hyperparams." + path[len(".hyperparams['"):-2]
        if path == ".inner_state[0].count":
            return "adam.count"
        moment, key = path[len(".inner_state[0]."):].split("[", 1)
        return f"{moment}.{key[1:-2]}"

    assert [name(p) for p in paths] == ckpt.opt_leaf_names(params)


def test_checkpoint_without_optimizer_state_loads_weights_only(tmp_path):
    model = _model(seed=5)
    path = ckpt.save_checkpoint(str(tmp_path / "w.npz"), model, epoch=3)
    other = _model(seed=6)
    opt = pt.make_optimizer(other, _pcfg())
    assert ckpt.load_checkpoint(path, other, opt) == 3
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 other.state_dict().values()))
    assert len(opt.state) == 0
    assert ckpt.latest_epoch(str(tmp_path)) == 0
    ckpt.save_checkpoint(str(tmp_path / "epoch_12.npz"), model, epoch=12)
    assert ckpt.latest_epoch(str(tmp_path)) == 12


# --------------------------------------------------------------------------
# remat, grad_accum, errors
# --------------------------------------------------------------------------


def _grads_of(cfg, batch, seed=7):
    model = _model(cfg.model.variant, seed=seed)
    loss, out = pt.accumulate_gradients(model, torch.from_numpy(batch[0]),
                                        torch.from_numpy(batch[1]), 1.0, None, cfg)
    return loss, out, _port_grads(model)


def test_remat_is_bitwise_on_the_cpu():
    batch = _batch(20)
    l0, o0, g0 = _grads_of(_pcfg(use_perceptual=False), batch)
    l1, o1, g1 = _grads_of(_pcfg(use_perceptual=False, remat=True), batch)
    assert torch.equal(l0, l1) and torch.equal(o0, o1)
    _equal_trees(g0, g1)


def test_grad_accum_matches_the_full_batch():
    batch = _batch(21, n=4)
    l0, o0, g0 = _grads_of(_pcfg(use_perceptual=False), batch)
    l2, o2, g2 = _grads_of(_pcfg(use_perceptual=False, grad_accum=2), batch)
    assert abs(l2.item() - l0.item()) <= 1e-6 * abs(l0.item())
    assert (o2 - o0).abs().max() <= 1e-6
    for k, ref in g0.items():
        assert np.abs(g2[k] - ref).max() <= 1e-5 * max(np.abs(ref).max(), 1e-30), k
    # and one update from each
    models = []
    for accum in (1, 2):
        cfg = _pcfg(use_perceptual=False, grad_accum=accum)
        m = _model(seed=7)
        pt.train_step(m, pt.make_optimizer(m, cfg), torch.from_numpy(batch[0]),
                      torch.from_numpy(batch[1]), 1.0, None, cfg)
        models.append(torch_to_jax_params(m.state_dict()))
    _lr_units(models[1], models[0], steps=1)


def test_indivisible_batch_raises_the_jax_message():
    low, high = _batch(22, n=2)
    with pytest.raises(ValueError) as ours:
        _grads_of(_pcfg(use_perceptual=False, grad_accum=3), (low, high))
    cfg = _jcfg(use_perceptual=False, grad_accum=3)
    opt = jt.make_optimizer(cfg)
    params = _jax_params(_model())
    with pytest.raises(ValueError) as ref:
        jt.make_train_step(cfg, opt)(params, opt.init(params), jnp.asarray(low), jnp.asarray(high),
                                     jnp.float32(1.0), None)
    assert str(ours.value) == str(ref.value) == "batch 2 must be divisible by --grad_accum 3"


@pytest.mark.parametrize("loss", [float("nan"), float("inf"), -float("inf")])
def test_nonfinite_guard_raises(loss):
    with pytest.raises(FloatingPointError, match="non-finite loss .* at epoch 3 step 4"):
        pt.nonfinite_guard(loss, 3, 4)
    pt.nonfinite_guard(1.5, 3, 4)


def test_master_weights_stay_fp32_in_a_bf16_step():
    cfg = _pcfg(use_perceptual=False, compute_dtype="bfloat16")
    model = _model(seed=8)
    opt = pt.make_optimizer(model, cfg)
    low, high = _batch(23)
    loss, out = pt.train_step(model, opt, torch.from_numpy(low), torch.from_numpy(high), 1.0,
                              None, cfg)
    assert torch.isfinite(loss) and out.dtype == torch.float32
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters())


# --------------------------------------------------------------------------
# launches per step (the kernels' dispatchers counted on the CPU)
# --------------------------------------------------------------------------

# base: the forward's K1-K7 and the loss's two K1; TNSM's training forward
# runs 12 LCAs (K5 1, K6 3, K7 2 each) and 12 TNSM blocks (K5 1, K6 4 each)
PER_STEP = {
    "base": {"K1": 1 + 2, "K2": 1, "K3": 6, "K4": 6, "K5": 11, "K6": 33, "K7": 22},
    "tnsm": {"K1": 1 + 2, "K2": 1, "K3": 6, "K4": 6, "K5": 24, "K6": 84, "K7": 24},
}
SITES = {"K1": [(cidnet_mod, "rgb_to_hvi"), (pt, "rgb_to_hvi")], "K2": [(cidnet_mod, "hvi_to_rgb")],
         "K3": [(layers, "half_prelu")], "K4": [(layers, "double_bilinear")],
         "K5": [(layers, "channel_attention"), (tnsm, "channel_attention")],
         "K6": [(layers, "layer_norm")], "K7": [(layers, "iel_branch")]}


def _counted(monkeypatch) -> dict:
    calls = {k: 0 for k in SITES}
    for key, sites in SITES.items():
        for module, attr in sites:
            fn = getattr(module, attr)

            def wrapper(*args, _fn=fn, _key=key, **kw):
                calls[_key] += 1
                return _fn(*args, **kw)
            monkeypatch.setattr(module, attr, wrapper)
    return calls


@pytest.mark.parametrize("variant,remat,accum", [
    ("base", False, 1), ("base", True, 1), ("base", False, 2), ("base", True, 2),
    ("tnsm", False, 1), ("tnsm", True, 2)],
    ids=["base-plain", "base-remat", "base-accum2", "base-remat_accum2", "tnsm-plain",
         "tnsm-remat_accum2"])
def test_launches_per_step(monkeypatch, variant, remat, accum):
    """remat runs the forward again in the backward (its launches double,
    the loss's two K1 do not); grad_accum a multiplies every count by a."""
    calls = _counted(monkeypatch)
    cfg = _pcfg(variant, use_perceptual=False, remat=remat, grad_accum=accum)
    model = CIDNet(CIDNetConfig(variant=variant, **TINY))
    low, high = _batch(24, n=2, hw=16)
    pt.train_step(model, pt.make_optimizer(model, cfg), torch.from_numpy(low),
                  torch.from_numpy(high), 1.0, None, cfg)
    want = {}
    for k, n in PER_STEP[variant].items():
        forward = n - 2 if k == "K1" else n
        want[k] = accum * (forward * (2 if remat else 1) + (2 if k == "K1" else 0))
    assert calls == want
