"""The plain reference against the program's plain path at a tiny size on
the CPU, its independence from the program, and the TF32 rounding."""

from __future__ import annotations

import ast
import subprocess
import sys

import pb_helpers
import pytest
import torch

from portbench import harness
from portbench.drivers import common
from portbench.reference import check, envs, ppo, policy, rng

REF = harness.PKG / "reference"


@pytest.mark.parametrize("cell", ["quad3d_fig8_ppo.train_b32k", "cartpole_stab_ppo.train_b32k",
                                  "quad3d_fig8_ppo.collect_b16k"])
def test_reference_follows_the_program(cell):
    correct, numbers = pb_helpers.run_small(cell)
    assert correct, numbers
    assert max(numbers.values()) < 1e-5, numbers


@pytest.mark.parametrize("name,T", [("quad3d_fig8_ppo", 30), ("cartpole_stab_ppo", 150)])
def test_reference_rollout_is_the_programs_record(name, T):
    """The reference's own rollout from its reset against the program's
    policy engine's first call, entry by entry."""
    from safe_control_gym_torch.controllers.ppo import fast_rollout_engine

    cell = harness.resolve(f"{name}.train_b32k")
    cfg, dev, B = cell.config, torch.device("cpu"), 24
    env = common.build_env(cfg, dev)
    engine, _ = fast_rollout_engine(env.config)
    fp = engine(env, B, T, mlp_hidden=16, mlp_act="tanh", device=dev)
    nx, nu = env.spaces.obs_dim, env.spaces.action_dim
    w = common.make_weights(11, nx, nu, 16, dev)
    from safe_control_gym_torch.controllers.ppo import ActorCritic
    from safe_control_gym_torch.parallel.fast_policy import pack_weights

    ac = ActorCritic(nx, nu, 16, "tanh")
    common.load_weights(ac, w)
    seed = torch.tensor([12345], dtype=torch.int32)
    _, traj = fp.run(fp.reset(7), pack_weights(ac.actor, ac.critic, ac.logstd), seed=seed)
    p = envs.params(cfg["family"], cfg["env"])
    recs, _ = ppo.rollout(p, "tanh", w, seed, ppo.reset(p, rng.env_seeds(7, B, dev)), T, "float32")
    from portbench.calibrate import record_of

    ref = record_of(recs)
    assert int(recs["done"].sum()) > 0
    assert torch.equal(traj[:, nx + nu + 1], ref[:, nx + nu + 1])  # done flags
    assert float((traj - ref).abs().max()) < 1e-5


def test_reference_imports_nothing_of_the_program_or_jax():
    banned = {"safe_control_gym_torch", "safe_control_gym_tpu", "jax", "jaxlib", "flax"}
    for path in [*REF.glob("*.py"), *(harness.PKG / "families").glob("*.py")]:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in banned, f"{path.name} imports {n}"
    code = ("import sys; sys.path.insert(0, %r); import portbench.reference.check; "
            "from portbench import families; "
            "[families.load(p.stem) for p in families.DIR.glob('[!_]*.py')]; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))") % (
        str(harness.ROOT), banned)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_tf32_rounds_to_ten_mantissa_bits_nearest_even():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-12, -1.0 - 2**-11,
                      3.0e38], dtype=torch.float32)
    y = policy.to_tf32(x)
    assert y.tolist()[:5] == [1.0, 1.0, 1.0 + 2**-9, 1.0, -1.0]
    assert float(y[5]) == pytest.approx(3.0e38, rel=1e-3)
    z = torch.randn(1000)
    assert float(((policy.to_tf32(z) - z).abs() / z.abs()).max()) <= 2**-11


def test_start_gap_reads_a_wrong_reset():
    cell = harness.resolve("quad3d_fig8_ppo.collect_b16k")
    cfg, dev = cell.config, torch.device("cpu")
    from safe_control_gym_torch.parallel.fast_policy import FastPolicyRollout

    fp = FastPolicyRollout(common.build_env(cfg, dev), 16, 4, device=dev)
    rows = fp.reset(5)
    p, es = envs.params("quad3d", cfg["env"]), rng.env_seeds(5, 16, dev)
    lay = cfg["program"]["rows"]
    assert check.start_gap(p, es, rows, lay) < 1e-6
    bad = rows.clone()
    bad[lay["inertial"][0], 3] *= 1.01
    assert check.start_gap(p, es, bad, lay) > 1e-4
