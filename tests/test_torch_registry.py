"""The port's registry (``utils/registration.py``, ``_registry_entries.py``,
the package's ``make``/``register``/``get_config``/``registry``) against the
JAX package's (tests/test_build.py holds the JAX registry): the same ids
and default configs, envs built from config dicts that reset and step as
the JAX package's do (states rtol 2e-4 / atol 2e-5), every controller id
built on a CPU env, LQR's action equal to JAX's (rtol 2e-4), and the two
errors."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import safe_control_gym_torch as tp
import safe_control_gym_tpu as jp
from safe_control_gym_torch.baseline import cfg4
from safe_control_gym_torch.utils import registration as treg
from safe_control_gym_tpu.utils import registration as jreg

IDS = jp.registry.ids()
CONTROLLERS = [i for i in IDS if i not in ("cartpole", "quadrotor")]
# The CartPole all but two controllers are built on: state constraints for
# CBF and SafeExplorerPPO, an adversary for RARL and RAP.
CART = dict(task="stabilization", cost="quadratic", episode_len_sec=2,
            constraints=({"constraint_form": "default_constraint",
                          "constrained_variable": "state"},),
            adversary_disturbance="dynamics")
QUAD3 = dict(quad_type=3, task="stabilization", cost="quadratic", episode_len_sec=2)


def test_surface_and_ids_match_jax():
    assert tp.registry.ids() == IDS and len(IDS) == 16
    assert tp.make is treg.make and tp.register is treg.register
    assert tp.get_config is treg.get_config and tp.registry is treg.registry
    assert tp.__version__ == jp.__version__


@pytest.mark.parametrize("cid", IDS)
def test_default_config_matches_jax(cid):
    cfg = tp.get_config(cid)
    assert cfg == jp.get_config(cid)
    cfg["mutated"] = 1  # a copy: the registered default stays as it was
    assert "mutated" not in tp.get_config(cid)
    ep = tp.registry.specs[cid].entry_point
    assert ep.replace("safe_control_gym_torch", "safe_control_gym_tpu") == \
        jp.registry.specs[cid].entry_point


def test_make_cartpole_episode_length_matches_jax():
    env = tp.make("cartpole", task="stabilization", episode_len_sec=2, device="cpu")
    jenv = jp.make("cartpole", task="stabilization", episode_len_sec=2)
    assert env.max_episode_steps == jenv.max_episode_steps == 100
    assert env.device == torch.device("cpu")


def test_make_quadrotor_from_config4_dict_matches_jax():
    """``make("quadrotor", **asdict(cfg4()))`` in both packages (the JAX one
    told ``use_pallas=False``, a key the port's builder drops, and a host
    loop's ``reseed_on_reset``, which both drop): the same reset draws from
    the same env seeds, then 8 steps of the same thrusts.  The ``dtype``
    field (each package's own float32 type) stays at its default."""
    cfg = {k: v for k, v in dataclasses.asdict(cfg4()).items() if k != "dtype"}
    env = tp.make("quadrotor", device="cpu", reseed_on_reset=True, **cfg)
    jenv = jp.make("quadrotor", use_pallas=False, reseed_on_reset=True, **cfg)
    assert env.max_episode_steps == jenv.max_episode_steps == 360
    B = 16
    js, jo, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(0), B))
    ts, to, _ = env.reset(torch.tensor(np.asarray(js.env_seed)))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6, atol=2e-7)
    np.testing.assert_allclose(ts.mass.numpy(), np.asarray(js.mass), rtol=1e-6)
    rng = np.random.default_rng(0)
    hover = float(jenv.u_goal[0])
    jstep = jax.jit(jax.vmap(jenv.step))
    for _ in range(8):
        a = (hover * (1.0 + 0.2 * rng.uniform(-1, 1, (B, 4)))).astype(np.float32)
        js, jo, jr, jd, _ = jstep(js, jnp.asarray(a))
        ts, to, tr, td, _ = env.step(ts, torch.from_numpy(a))
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.fixture(scope="module")
def cpu_envs():
    return {"cart": tp.make("cartpole", device="cpu", **CART),
            "quad3": tp.make("quadrotor", device="cpu", **QUAD3)}


@pytest.mark.parametrize("cid", CONTROLLERS)
def test_make_builds_every_controller_on_the_cpu(cid, cpu_envs):
    """Each controller id from its default config on a CPU env (the PID and
    the Mellinger controller fly quadrotors): the class the JAX registry
    names, holding the env it was given."""
    env = cpu_envs["quad3" if cid in ("pid", "mellinger") else "cart"]
    ctrl = tp.make(cid, env, **tp.get_config(cid))
    assert type(ctrl).__name__ == jreg.load(jp.registry.specs[cid].entry_point).__name__
    assert ctrl.env is env
    state = getattr(ctrl, "state", None)
    for t in (getattr(state, "obs", None), getattr(getattr(state, "ac", None), "logstd", None)):
        if isinstance(t, torch.Tensor):
            assert t.device.type == "cpu"


def test_make_lqr_action_matches_jax():
    """tests/test_build.py:37-43 in both packages: LQR from the registry on
    CartPole with the quadratic cost, its action at the origin."""
    env = tp.make("cartpole", task="stabilization", cost="quadratic", episode_len_sec=2,
                  device="cpu")
    jenv = jp.make("cartpole", task="stabilization", cost="quadratic", episode_len_sec=2)
    lqr = tp.make("lqr", env, q_lqr=[1.0], r_lqr=[0.1])
    jlqr = jp.make("lqr", jenv, q_lqr=[1.0], r_lqr=[0.1])
    obs = np.array([0.1, -0.2, 0.05, 0.3], np.float32)
    a, ja = lqr.select_action(np.zeros(4, np.float32)), jlqr.select_action(jnp.zeros(4))
    assert a.shape == np.asarray(ja).shape == (1,)
    np.testing.assert_allclose(a, np.asarray(ja), atol=1e-6)
    np.testing.assert_allclose(lqr.select_action(obs), np.asarray(jlqr.select_action(obs)),
                               rtol=2e-4, atol=1e-5)


def test_registry_errors():
    r = treg.Registry()
    r.register("x", lambda **kw: kw, {"a": 1})
    assert r.make("x", b=2) == {"b": 2} and r.get_config("x") == {"a": 1}
    with pytest.raises(ValueError, match="re-register"):
        r.register("x", "m:f")
    with pytest.raises(ValueError, match="re-register"):
        tp.register("ppo", "safe_control_gym_torch.controllers.ppo:PPO")
    with pytest.raises(KeyError, match="known:.*cartpole"):
        tp.make("no_such_id")
    with pytest.raises(KeyError, match="no_such_id"):
        tp.get_config("no_such_id")


def test_config_from_a_yaml_path(tmp_path):
    """A config entry point given as a YAML file, by path and as
    ``package.module:relative/path.yaml``."""
    (tmp_path / "c.yaml").write_text("horizon: 7\nq: [1.0, 2.0]\n")
    r = treg.Registry()
    r.register("a", "safe_control_gym_torch.controllers.lqr:LQR", str(tmp_path / "c.yaml"))
    assert r.get_config("a") == {"horizon": 7, "q": [1.0, 2.0]}
    r.register("b", "m:f", "safe_control_gym_tpu.competition:levels/level0.yaml")
    assert "quadrotor_config" in r.get_config("b")
