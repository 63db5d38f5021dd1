"""The rest of the env surface in the port against the JAX package on the
CPU: the aero physics modes (1D, 2D and 3D), the constraint forms
(linear, quadratic, symmetric; the input_and_state variable), the
periodic, brownian and state_dependent disturbances and white noise on the
dynamics channel, more than one randomized step offset per channel, and
the adversary channel of both envs.

Tolerances: the deterministic parts (aero, constraint values, the
state_dependent force, the adversary's offsets, the periodic formula on a
given phase, impulses at given offsets) at the JAX suite's (states rtol
2e-4 / atol 2e-5, tests/test_fast_env.py:85), done and violation flags
exact.  The threefry-drawn parts (the periodic phase, white noise, the
brownian increments, the extra randomized offsets) in distribution only,
each test naming its sample size and bound: the port draws them from
Philox and the counter PRNG, not threefry."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_gym_torch.envs import cartpole as tc
from safe_control_gym_torch.envs import constraints as tcon
from safe_control_gym_torch.envs import disturbances as tdist
from safe_control_gym_torch.envs import quadrotor as tq
from safe_control_gym_torch.envs.benchmark import EnvSpaces
from safe_control_gym_torch.ops import ctr_prng
from safe_control_gym_torch.parallel import fast_cartpole as tfc
from safe_control_gym_torch.parallel import fast_env as tfe
from safe_control_gym_torch.parallel import fast_quad_planar as tfq
from safe_control_gym_torch.parallel.vector import make_vec_env
from safe_control_gym_torch.utils.convert import cartpole_state_from_numpy, quad_state_from_numpy
from safe_control_gym_tpu.envs import cartpole as jc
from safe_control_gym_tpu.envs import constraints as jcon
from safe_control_gym_tpu.envs import disturbances as jdist
from safe_control_gym_tpu.envs import quadrotor as jq
from safe_control_gym_tpu.parallel import fast_cartpole as jfc
from safe_control_gym_tpu.parallel import fast_env as jfe
from safe_control_gym_tpu.parallel import fast_quad_planar as jfq

B = 64
STEPS = 4
# A low, fast start (ground effect below ~0.1 m, drag at ~1 m/s).
LOW_FAST = {"init_x": {"distrib": "uniform", "low": -0.5, "high": 0.5},
            "init_x_dot": {"distrib": "uniform", "low": -1.0, "high": 1.0},
            "init_y": {"distrib": "uniform", "low": -0.5, "high": 0.5},
            "init_y_dot": {"distrib": "uniform", "low": -1.0, "high": 1.0},
            "init_z": {"distrib": "uniform", "low": 0.02, "high": 0.3},
            "init_z_dot": {"distrib": "uniform", "low": -0.5, "high": 0.5},
            "init_theta": {"distrib": "uniform", "low": -0.3, "high": 0.3},
            "init_phi": {"distrib": "uniform", "low": -0.3, "high": 0.3}}
QUAD = dict(ctrl_freq=60, pyb_freq=240, episode_len_sec=2, task="stabilization",
            task_info={"stabilization_goal": [0, 0, 1], "stabilization_goal_tolerance": 0.05},
            randomized_init=True, randomized_inertial_prop=True, done_on_out_of_bound=True)
CART = dict(ctrl_freq=50, pyb_freq=50, episode_len_sec=2, task="stabilization",
            randomized_init=True)


def _quads(**kw):
    cfg = {**QUAD, **kw}
    return (jq.make_quadrotor(jq.QuadrotorConfig(**cfg, use_pallas=False)),
            tq.make_quadrotor(tq.QuadrotorConfig(**cfg), device="cpu"))


def _carts(**kw):
    cfg = {**CART, **kw}
    return (jc.make_cartpole(jc.CartPoleConfig(**cfg)),
            tc.make_cartpole(tc.CartPoleConfig(**cfg), device="cpu"))


def _start(jenv, convert, n=B, key=1):
    """The JAX batch's reset and the same states in the port."""
    js, _, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(key), n))
    fields = jax.tree.map(np.asarray, {k: getattr(js, k) for k in js.__dataclass_fields__
                                        if k != "key"})
    return js, convert(fields, "cpu")


_JSTEP = {}


def _run(jenv, tenv, js, ts, actions, adv=None):
    """Step both packages through ``actions`` (steps, n, nu) (with the
    adversary's ``adv`` (steps, n, k) set before each step), holding states,
    rewards and done flags at the suite's tolerances after each step."""
    jstep = _JSTEP.setdefault(id(jenv), (jenv, jax.jit(jax.vmap(jenv.step))))[1]
    for t, a in enumerate(actions):
        if adv is not None:
            js = jax.vmap(jenv.extras["set_adversary_control"])(js, jnp.asarray(adv[t]))
            ts = tenv.extras["set_adversary_control"](ts, torch.from_numpy(adv[t]))
        js, jo, jr, jd, ji = jstep(js, jnp.asarray(a))
        ts, to, tr, td, ti = tenv.step(ts, torch.from_numpy(a))
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=2e-4, atol=1e-5)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        if "constraint_violation" in ji:
            np.testing.assert_array_equal(ti["constraint_violation"].numpy(),
                                          np.asarray(ji["constraint_violation"]))
    return js, ts, ti, ji


def _hover_actions(env, n=B, steps=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    nu = env.spaces.action_dim
    return (float(env.u_goal[0]) * (1.0 + 0.3 * rng.uniform(-1, 1, (steps, n, nu)))).astype(
        np.float32)


# -- aero physics modes -------------------------------------------------------

@pytest.mark.parametrize("quad_type, physics", [
    (3, "pyb_gnd"), (3, "pyb_drag"), (3, "pyb_dw"), (3, "pyb_gnd_drag_dw"),
    (2, "pyb_gnd_drag_dw"), (1, "pyb_gnd_drag_dw")])
def test_aero_modes_match_jax(quad_type, physics):
    """Ground effect, drag, downwash (a single drone's: no term) and all
    three on the 3D body, and all three on the 1D and 2D bodies (whose
    aero branches the combined mode runs whole), STEPS steps from low, fast
    starts near the ground:
    states, observations, rewards and done flags against the JAX package's
    ``_aero`` physics at the suite's tolerances; the ground effect and drag
    move the states off the plain physics."""
    labels = tq.TYPE_INIT_LABELS[quad_type]
    kw = dict(quad_type=quad_type, physics=physics,
              init_state_randomization_info={k: v for k, v in LOW_FAST.items() if k in labels})
    jenv, tenv = _quads(**kw)
    js, ts = _start(jenv, quad_state_from_numpy)
    acts = _hover_actions(tenv)
    _, ts1, _, _ = _run(jenv, tenv, js, ts, acts)
    plain = tq.make_quadrotor(tq.QuadrotorConfig(**{**QUAD, **kw, "physics": "pyb"}),
                              device="cpu")
    ts_plain = _start(jenv, quad_state_from_numpy)[1]
    for a in acts:
        ts_plain = plain.step(ts_plain, torch.from_numpy(a))[0]
    moved = not torch.allclose(ts1.x, ts_plain.x, rtol=1e-6, atol=1e-7)
    assert moved == (physics != "pyb_dw")


@pytest.mark.parametrize("physics", ["pyb", "pyb_dw", "pyb_gnd", "pyb_drag", "pyb_gnd_drag_dw"])
def test_aero_modes_bypass_k1(physics, monkeypatch):
    """As in the JAX package (quadrotor.py:785-789), the 3D ground-effect
    and drag modes integrate the plain rigid body with the aero terms in
    every stage and do not go through K1; pyb and pyb_dw take K1 once a
    step."""
    calls = []
    real = tq.quad3d_substeps

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tq, "quad3d_substeps", counting)
    env = tq.make_quadrotor(tq.QuadrotorConfig(**QUAD, quad_type=3, physics=physics),
                            device="cpu")
    s, _, _ = env.reset(torch.arange(8, dtype=torch.int32))
    for _ in range(3):
        s = env.step(s, torch.full((8, 4), float(env.u_goal[0])))[0]
    assert len(calls) == (3 if physics in ("pyb", "pyb_dw") else 0)


def test_aero_constants_match_jax():
    for name in ("GND_EFF_COEFF", "PROP_RADIUS", "DRAG_COEFF", "GND_EFF_H_CLIP", "MAX_RPM",
                 "MAX_THRUST", "THRUST2WEIGHT"):
        assert np.allclose(getattr(tq, name), getattr(jq, name), rtol=1e-15, atol=0), name


# -- constraint forms ---------------------------------------------------------

_SPECS = (
    {"constraint_form": "default_constraint", "constrained_variable": "state"},
    {"constraint_form": "linear_constraint", "constrained_variable": "state",
     "A": [[1.0, -2.0], [0.5, 0.5]], "b": [0.3, 0.2], "active_dims": [0, 4]},
    {"constraint_form": "quadratic_constraint", "constrained_variable": "state",
     "P": [[1.0, 0.2], [0.2, 2.0]], "b": 0.5, "active_dims": [6, 7], "strict": True},
    {"constraint_form": "symmetric_constraint", "constrained_variable": "state",
     "bound": [0.2, 0.3, 0.1], "active_dims": [1, 3, 5], "tolerance": 0.05},
    {"constraint_form": "bounded_constraint", "constrained_variable": "input",
     "lower_bounds": [0.05] * 4, "upper_bounds": [0.12] * 4, "tolerance": [0.01] * 8},
    {"constraint_form": "quadratic_constraint", "constrained_variable": "input",
     "P": np.eye(4).tolist(), "b": 0.03},
    {"constraint_form": "linear_constraint", "constrained_variable": "input_and_state",
     "A": [[0.1] * 16, [0.0] * 12 + [1.0, -1.0, 0.0, 0.0]], "b": [0.4, 0.01]},
)


def test_constraint_forms_match_jax():
    """Every form on random states and inputs (4096 of them): the raw and
    the rounded values (rtol 2e-4 / atol 2e-6: float32 products summed in
    other orders), row order, strictness, tolerances and the state rows,
    and the violation and almost-active flags exactly (the rows are kept
    1e-5 clear of 0 and of their tolerance edges)."""
    jenv, tenv = _quads(quad_type=3)
    sp = tenv.spaces
    jc_ = jcon.build_constraints(_SPECS, jenv.spaces)
    tc_ = tcon.build_constraints(_SPECS, sp, "cpu")
    assert tc_.num_constraints == jc_.num_constraints == 24 + 2 + 1 + 3 + 8 + 1 + 2
    np.testing.assert_array_equal(tc_.strict.numpy(), jc_.strict)
    np.testing.assert_array_equal(tc_.tolerance.numpy(), jc_.tolerance.astype(np.float32))
    np.testing.assert_array_equal(tc_.state_only_rows, jc_.state_only_rows)
    np.testing.assert_array_equal(tc_.input_rows, jc_.input_rows)
    np.testing.assert_array_equal(tc_.row_order.numpy(), jc_.row_order)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (4096, 12)).astype(np.float32)
    u = rng.uniform(0.0, 0.2, (4096, 4)).astype(np.float32)
    jraw = np.asarray(jc_.get_values_raw(jnp.asarray(x), jnp.asarray(u)))
    traw = tc_.get_values_raw(torch.from_numpy(x), torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(traw, jraw, rtol=2e-4, atol=2e-6)
    jv = np.asarray(jc_.get_values(jnp.asarray(x), jnp.asarray(u)))
    tv = tc_.get_values(torch.from_numpy(x), torch.from_numpy(u))
    np.testing.assert_allclose(tv.numpy(), jv, rtol=2e-4, atol=2e-6)
    clear = ((np.abs(jraw) > 1e-5) & (np.abs(jraw + jc_.tolerance) > 1e-5)).all(-1)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(tc_.is_violated(tv).numpy()[clear],
                                  np.asarray(jc_.is_violated(jv))[clear])
    np.testing.assert_array_equal(tc_.is_almost_active(tv).numpy()[clear],
                                  np.asarray(jc_.is_almost_active(jv))[clear])
    np.testing.assert_allclose(tc_.get_state_values(torch.from_numpy(x)).numpy(),
                               np.asarray(jc_.get_state_values(jnp.asarray(x))), rtol=2e-4,
                               atol=2e-6)


@pytest.mark.parametrize("k", range(1, len(_SPECS)))
def test_non_box_forms_stay_off_the_fast_engines(k):
    """box_bounds_view is None for every non-box program, so the
    whole-rollout engines refuse them, as the JAX package's do; the box
    program of the first spec stays in the envelope."""
    specs = (_SPECS[0], _SPECS[k])
    box = _SPECS[k]["constraint_form"] in ("bounded_constraint", "default_constraint")
    assert (tcon.box_bounds_view(specs, 12, 4) is None) == (not box)
    assert (jcon.box_bounds_view(specs, 12, 4) is None) == (not box)
    cfg = {**QUAD, "quad_type": 3, "constraints": specs}
    assert tfe.supports(tq.QuadrotorConfig(**cfg)) == jfe.supports(jq.QuadrotorConfig(**cfg)) \
        == box


def test_constraint_env_step_matches_jax():
    """A quadrotor with the non-box forms, done on violation and the
    constraint penalty: STEPS steps against the JAX env, constraint values
    at the tolerances and violation flags exact (via _run)."""
    jenv, tenv = _quads(quad_type=3, constraints=_SPECS, done_on_violation=True,
                        use_constraint_penalty=True)
    js, ts = _start(jenv, quad_state_from_numpy)
    _, _, ti, ji = _run(jenv, tenv, js, ts, _hover_actions(tenv))
    np.testing.assert_allclose(ti["constraint_values"].numpy(), np.asarray(ji["constraint_values"]),
                               rtol=2e-4, atol=2e-5)
    assert np.asarray(ji["constraint_violation"]).any()


# -- disturbances -------------------------------------------------------------

def test_state_dependent_disturbance_matches_jax():
    """The friction-like -coeff * x[state_index] on the dynamics channel
    (quadrotor, masked) and on the action channel (CartPole): STEPS steps
    against the JAX env at the suite's tolerances."""
    dyn = {"dynamics": ({"disturbance_func": "state_dependent", "state_index": [1, 3, 5],
                         "coeff": [0.05, 0.1, 0.02], "mask": [1, 1, 0]},)}
    jenv, tenv = _quads(quad_type=3, disturbances=dyn, init_state_randomization_info=LOW_FAST)
    js, ts = _start(jenv, quad_state_from_numpy)
    _run(jenv, tenv, js, ts, _hover_actions(tenv))
    act = {"action": ({"disturbance_func": "state_dependent", "state_index": [1],
                       "coeff": 2.0},)}
    jenv, tenv = _carts(disturbances=act)
    js, ts = _start(jenv, cartpole_state_from_numpy)
    _run(jenv, tenv, js, ts, np.random.default_rng(1).uniform(-3, 3, (STEPS, B, 1)).astype(
        np.float32))


N = 1 << 15  # samples of the distribution tests


def _noise(prog, ctrl_step=0, pyb_step=0, walk=None, n=N):
    es = ctr_prng.env_seeds_from_seed(0, n)
    return prog.apply(torch.zeros((n, 0), dtype=torch.int32),
                      torch.full((n,), ctrl_step, dtype=torch.int32),
                      torch.zeros((n, prog.dim)), (es, torch.zeros_like(es)),
                      torch.full((n,), pyb_step, dtype=torch.int32), None, walk)


def _jnoise(jprog, ctrl_step=0, pyb_step=0, n=N):
    keys = jax.random.split(jax.random.key(0), n)
    return np.asarray(jax.vmap(lambda k: jprog.apply(
        jprog.init(k), k, jnp.int32(ctrl_step), jnp.int32(pyb_step),
        jnp.zeros(jprog.dim, jnp.float32)))(keys), float)


def test_periodic_formula_and_distribution():
    """The periodic kind, scale * sin(2 pi f t + phase) at t = pyb_step *
    pyb_dt: exactly that of the port's own phase draws (Philox, the
    entry's), inside [-scale, scale]; over N = 2^15 samples its mean within
    4 standard errors of 0 and of the JAX package's, its std within 2% of
    the JAX package's and of scale / sqrt(2) (a uniform phase), the masked
    dim zero."""
    spec = ({"disturbance_func": "periodic", "scale": 0.3, "frequency": 2.0,
             "mask": [1, 1, 0]},)
    prog = tdist.build_disturbances(spec, 3, 5, 50, channel="dynamics", pyb_freq=200)
    jprog = jdist.build_disturbances(spec, 3, 5, 50, 200)
    t = _noise(prog, ctrl_step=7, pyb_step=28).double().numpy()
    j = _jnoise(jprog, ctrl_step=7, pyb_step=28)
    es = ctr_prng.env_seeds_from_seed(0, N)
    from safe_control_gym_torch.ops import philox

    u = philox.block_uniforms(torch.full((N,), 7), 0, philox.SITE_DYNAMICS, es,
                              torch.zeros_like(es), 3).T
    phase = -np.pi + u * (2.0 * np.pi)
    want = 0.3 * torch.sin(2.0 * np.pi * 2.0 * (torch.full((N, 1), 28.0) * (1.0 / 200)) + phase)
    np.testing.assert_array_equal(t[:, :2], (want * torch.tensor([1.0, 1.0, 0.0]))[:, :2].double())
    assert np.abs(t).max() <= np.float32(0.3) and not t[:, 2].any() and not j[:, 2].any()
    sd = 0.3 / np.sqrt(2)
    for k in range(2):
        for m in (t[:, k].mean(), j[:, k].mean()):
            assert abs(m) < 4 * sd / np.sqrt(N)
        assert abs(t[:, k].std() / j[:, k].std() - 1) < 0.02
        assert abs(t[:, k].std() / sd - 1) < 0.02


def test_dynamics_white_noise_distribution():
    """White noise on the dynamics channel over N = 2^15 samples: mean
    within 4 standard errors of 0, std within 2% of the JAX package's and
    of the configured per-dim std, the masked dim zero; a second entry
    draws other words."""
    spec = ({"disturbance_func": "white_noise", "std": [0.1, 0.2, 0.05], "mask": [1, 1, 0]},
            {"disturbance_func": "white_noise", "std": 0.1})
    prog = tdist.build_disturbances(spec[:1], 3, 5, 50, channel="dynamics")
    jprog = jdist.build_disturbances(spec[:1], 3, 5, 50, 50)
    t, j = _noise(prog).double().numpy(), _jnoise(jprog)
    for k, std in enumerate((0.1, 0.2)):
        assert abs(t[:, k].mean()) < 4 * std / np.sqrt(N)
        assert abs(t[:, k].std() / std - 1) < 0.02
        assert abs(t[:, k].std() / j[:, k].std() - 1) < 0.02
    assert not t[:, 2].any()
    two = tdist.build_disturbances(spec, 3, 5, 50, channel="dynamics")
    both = _noise(two).double().numpy()
    assert np.corrcoef(both[:, 0] - t[:, 0], t[:, 0])[0, 1] < 0.05


def test_brownian_walk_distribution():
    """The brownian walk (disturbances.py:95-116) starts at 0 each episode
    and steps std * sqrt(ctrl_dt) * N once a control step: after K = 12
    steps of N = 2^14 envs its per-dim std within 3% of the JAX package's
    walk and of std * sqrt(K ctrl_dt), mean within 4 standard errors of 0;
    apply adds the walk times the mask, drawing nothing."""
    n, K = 1 << 14, 12
    spec = ({"disturbance_func": "brownian", "std": [0.1, 0.3], "mask": [1, 0]},
            {"disturbance_func": "brownian", "std": 0.2})
    prog = tdist.build_disturbances(spec, 2, 5, 50, channel="action")
    jprog = jdist.build_disturbances(spec, 2, 5, 50, 50)
    assert prog.walk_dim == jprog.walk_dim == 4
    es = ctr_prng.env_seeds_from_seed(3, n)
    ident = (es, torch.zeros_like(es))
    walk = torch.zeros((n, 4))
    for k in range(K):
        walk = prog.evolve(walk, torch.full((n,), k, dtype=torch.int32), ident)
    keys = jax.random.split(jax.random.key(0), n)

    def jwalk(key):
        s = jprog.init(key)
        for k in range(K):
            s = jprog.evolve(s, jax.random.fold_in(key, k))
        return s["walk"]

    jw = np.asarray(jax.vmap(jwalk)(keys), float)
    tw = walk.double().numpy()
    for d, std in enumerate((0.1, 0.3, 0.2, 0.2)):
        want = std * np.sqrt(K / 50)
        assert abs(tw[:, d].mean()) < 4 * want / np.sqrt(n)
        assert abs(tw[:, d].std() / want - 1) < 0.03
        assert abs(tw[:, d].std() / jw[:, d].std() - 1) < 0.03
    out = prog.apply(torch.zeros((n, 0), dtype=torch.int32), torch.zeros(n, dtype=torch.int32),
                     torch.ones((n, 2)), ident, torch.zeros(n, dtype=torch.int32), None, walk)
    want = 1.0 + walk[:, :2] * torch.tensor([1.0, 0.0]) + walk[:, 2:]
    assert torch.equal(out, want)


def test_brownian_walk_in_the_env():
    """A quadrotor with a brownian dynamics force: the walk is carried in
    the state, starts at zero, moves each step, makes the first step the
    JAX package's (its walk is zero too) and restarts at zero when the
    vector env resets an env."""
    dyn = {"dynamics": ({"disturbance_func": "brownian", "std": 0.05},)}
    jenv, tenv = _quads(quad_type=3, disturbances=dyn, episode_len_sec=0.1)
    js, ts = _start(jenv, quad_state_from_numpy)
    assert not ts.dist_walk["dynamics"].any() and ts.dist_walk["dynamics"].shape == (B, 3)
    acts = _hover_actions(tenv, steps=1)
    _, ts1, _, _ = _run(jenv, tenv, js, ts, acts)
    assert (ts1.dist_walk["dynamics"] != 0).all()
    vec = make_vec_env(tenv, B)
    s, _, _ = vec.reset(seed=0)
    for _ in range(6):  # the 6-step episode ends on the sixth
        s, _, _, done, _ = vec.step(s, torch.from_numpy(acts[0]))
    assert done.all() and not s.dist_walk["dynamics"].any()


# -- randomized step offsets --------------------------------------------------

MANY = {"action": ({"disturbance_func": "impulse", "magnitude": 0.01, "duration": 3},
                   {"disturbance_func": "step", "magnitude": -0.005}),
        "observation": ({"disturbance_func": "step", "magnitude": 0.1,
                         "mask": [1] + [0] * 11},),
        "dynamics": ({"disturbance_func": "impulse", "magnitude": 0.02, "duration": 4},)}


def test_many_offsets_distribution_and_single_dynamics_offset_exact():
    """Four randomized offsets over three channels: every offset in [0,
    max_steps), over 4096 envs uniform like the JAX package's threefry
    randint (mean and std within 5% of the JAX sample's), the offsets of
    one env different from each other's; the single dynamics offset stays
    the counter draw of slot 4 + nx, bit for bit with the JAX package's."""
    n = 4096
    jenv, tenv = _quads(quad_type=3, disturbances=MANY)
    js, ts = _start(jenv, quad_state_from_numpy, n=n)
    own, _, _ = tenv.reset(torch.tensor(np.asarray(js.env_seed)))
    np.testing.assert_array_equal(own.dist_offsets["dynamics"].numpy(),
                                  np.asarray(js.dist_sched["dynamics"]["offsets"]))
    ms = int(2 * 60)
    t = torch.cat([own.dist_offsets[c] for c in ("observation", "action")], -1).numpy()
    j = np.concatenate([np.asarray(js.dist_sched[c]["offsets"]) for c in ("observation",
                                                                            "action")], -1)
    assert t.shape == j.shape == (n, 3) and t.min() >= 0 and t.max() < ms
    for k in range(3):
        assert abs(t[:, k].mean() / j[:, k].mean() - 1) < 0.05
        assert abs(t[:, k].std() / j[:, k].std() - 1) < 0.05
    assert (t[:, 1] != t[:, 2]).mean() > 0.95


def test_many_offsets_steps_match_jax_at_given_offsets():
    """Given the same offsets (the JAX state's, carried by utils/convert),
    the scheduled impulses and steps are deterministic: STEPS steps from
    step 0 and from the offsets' windows against the JAX env."""
    jenv, tenv = _quads(quad_type=3, disturbances=MANY)
    js, ts = _start(jenv, quad_state_from_numpy)
    _run(jenv, tenv, js, ts, _hover_actions(tenv))
    off = np.asarray(js.dist_sched["action"]["offsets"])[:, 0]
    js = js.replace(ctrl_step=jnp.asarray(off, jnp.int32), pyb_step=jnp.asarray(4 * off, jnp.int32))
    ts = ts.replace(ctrl_step=torch.from_numpy(off.astype(np.int32)),
                    pyb_step=torch.from_numpy(4 * off.astype(np.int32)))
    _run(jenv, tenv, js, ts, _hover_actions(tenv, seed=1))


def test_cartpole_many_offsets():
    """CartPole with randomized offsets on all three channels: the single
    dynamics offset bit for bit with the JAX package's (counter slot 7),
    the others in [0, max_steps) and, given the JAX state's, the steps
    against the JAX env."""
    dist = {"action": ({"disturbance_func": "step", "magnitude": 0.5},),
            "observation": ({"disturbance_func": "impulse", "magnitude": 0.2, "duration": 2},),
            "dynamics": ({"disturbance_func": "impulse", "magnitude": 1.0, "duration": 4},)}
    jenv, tenv = _carts(disturbances=dist)
    js, ts = _start(jenv, cartpole_state_from_numpy)
    own, _, _ = tenv.reset(torch.tensor(np.asarray(js.env_seed)))
    np.testing.assert_array_equal(own.dist_offsets["dynamics"].numpy(),
                                  np.asarray(js.dist_sched["dynamics"]["offsets"]))
    for c in ("action", "observation"):
        o = own.dist_offsets[c].numpy()
        assert o.shape == (B, 1) and o.min() >= 0 and o.max() < 100
    _run(jenv, tenv, js, ts, np.random.default_rng(2).uniform(-3, 3, (STEPS, B, 1)).astype(
        np.float32))


# -- the adversary channel ----------------------------------------------------

@pytest.mark.parametrize("quad_type", [1, 2, 3])
@pytest.mark.parametrize("channel", ["action", "dynamics"])
def test_quadrotor_adversary_matches_jax(quad_type, channel):
    """set_adversary_control clips, scales and offsets the adversary's action
    and the step adds it (after the action disturbances, or to the world
    force: 1D on z, 2D on x and z), then zeroes it: STEPS steps against the
    JAX env with a fresh adversary action before each, at the suite's
    tolerances."""
    jenv, tenv = _quads(quad_type=quad_type, adversary_disturbance=channel,
                        adversary_disturbance_scale=0.05 if channel == "action" else 0.02,
                        adversary_disturbance_offset=0.001)
    js, ts = _start(jenv, quad_state_from_numpy)
    k = tenv.spaces.action_dim if channel == "action" else {1: 1, 2: 2, 3: 3}[quad_type]
    adv = np.random.default_rng(3).uniform(-1.5, 1.5, (STEPS, B, k)).astype(np.float32)
    _, ts1, _, _ = _run(jenv, tenv, js, ts, _hover_actions(tenv), adv=adv)
    assert not ts1.adv_force.any() and not ts1.adv_act.any()


@pytest.mark.parametrize("channel", ["action", "dynamics"])
def test_cartpole_adversary_matches_jax(channel):
    """The CartPole's adversary: its action offset joins before the action
    disturbances (cartpole.py:363-366), its force on the cart beside the
    dynamics disturbance; STEPS steps against the JAX env."""
    jenv, tenv = _carts(adversary_disturbance=channel, adversary_disturbance_scale=2.0,
                        disturbances={"action": ({"disturbance_func": "step",
                                                  "magnitude": 0.5, "step_offset": 1},)})
    js, ts = _start(jenv, cartpole_state_from_numpy)
    adv = np.random.default_rng(4).uniform(-1.5, 1.5, (STEPS, B, 1)).astype(np.float32)
    acts = np.random.default_rng(5).uniform(-3, 3, (STEPS, B, 1)).astype(np.float32)
    _run(jenv, tenv, js, ts, acts, adv=adv)


def test_adversary_needs_its_config():
    """Both packages raise where the env has no adversary channel, and the
    fast engines refuse an adversary config, as the JAX package's do."""
    for jenv, tenv, conv in ((*_quads(quad_type=3), quad_state_from_numpy),
                             (*_carts(), cartpole_state_from_numpy)):
        js, ts = _start(jenv, conv, n=4)
        with pytest.raises(RuntimeError):
            tenv.extras["set_adversary_control"](ts, torch.zeros((4, 1)))
        with pytest.raises(RuntimeError):
            jax.vmap(jenv.extras["set_adversary_control"])(js, jnp.zeros((4, 1)))
    q = {**QUAD, "quad_type": 3, "adversary_disturbance": "dynamics"}
    assert not tfe.supports(tq.QuadrotorConfig(**q)) and not jfe.supports(jq.QuadrotorConfig(**q))
    q2 = dict(q, quad_type=2)
    assert not tfq.supports(tq.QuadrotorConfig(**q2)) and not jfq.supports(
        jq.QuadrotorConfig(**q2))
    c = {**CART, "adversary_disturbance": "action"}
    assert not tfc.supports(tc.CartPoleConfig(**c)) and not jfc.supports(jc.CartPoleConfig(**c))


def test_unknown_kinds_and_channels_raise():
    """What neither package takes raises when the env is built."""
    with pytest.raises(ValueError):
        tq.make_quadrotor(tq.QuadrotorConfig(**QUAD, physics="pyb_magic"), device="cpu")
    with pytest.raises(ValueError):
        tq.make_quadrotor(tq.QuadrotorConfig(**QUAD, adversary_disturbance="observation"),
                          device="cpu")
    with pytest.raises(ValueError):
        tdist.build_disturbances(({"disturbance_func": "gust"},), 3, 5, 50, channel="dynamics")
    sp = EnvSpaces(*(np.zeros(2),) * 6)
    with pytest.raises(ValueError):
        tcon.build_constraints(({"constraint_form": "symmetric_constraint",
                                 "constrained_variable": "input", "bound": [1.0]},), sp, "cpu")
    assert dataclasses.is_dataclass(tq.QuadState)
