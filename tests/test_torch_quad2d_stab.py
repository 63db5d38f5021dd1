"""The 2D quadrotor's stabilization under PPO (``portbench/configs/
quad2d_stab_ppo.json``) against the benchmark's plain reference
(``portbench/families/quad2d.py``, ``portbench/reference/``), on the CPU
with seeded random weights: K8's plain path through
``FastPlanarQuadPolicyRollout`` against the reference over
out-of-bound resets and time-limit truncations, its reset rows against the
reference's draws, PPO's first train steps against the reference's, the
planted faults each comparison must catch, and the family file's
independence from the program and JAX."""

from __future__ import annotations

import ast
import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402
from portbench.drivers import common  # noqa: E402
from portbench.reference import check, envs, held_rows, rng  # noqa: E402
from safe_control_gym_torch.controllers.ppo import ActorCritic, fast_rollout_engine  # noqa: E402
from safe_control_gym_torch.ops import ctr_prng  # noqa: E402
from safe_control_gym_torch.parallel import fast_quad_planar as PQ  # noqa: E402
from safe_control_gym_torch.parallel.fast_policy import pack_weights  # noqa: E402

CELL = "quad2d_stab_ppo.collect_b16k"
B, T, H, SEED = 64, 24, 64, 2**31 + 4099
NEAR_LIMIT = 295.0  # a step row 5 short of the 300-step episode: truncates within T
# This file's own tolerances (the benchmark's limit files are the harness's):
# a sound record reads 5.4e-7 on the CPU and at most 1.43e-6 on the card, a
# planted fault 0.52 or more; the train step's are the 3D quadrotor's.
SOUND_GAP = 1e-5
FAULT_GAP = 1e-4
TRAIN_LIMITS = {"loss_gap": 6e-06, "grad_norm_gap": 2e-05, "change_norm_gap": 0.00025}
FAMILY_FILES = [ROOT / "portbench" / "families" / "quad2d.py",
                ROOT / "portbench" / "reference" / "held_rows.py"]


def _config(randomized_inertia=False):
    cfg = copy.deepcopy(harness.resolve(CELL).config)
    cfg["env"]["randomized_inertial_prop"] = randomized_inertia
    return cfg


def _rollout(cfg, rows_fn=None):
    """The program's first K8 call on the CPU from its reset (rows edited by
    ``rows_fn``); returns (params, env seeds, rows in, record, rows out,
    weights, call seed)."""
    dev = torch.device("cpu")
    env = common.build_env(cfg, dev)
    engine, ok = fast_rollout_engine(env.config)
    assert ok and engine is PQ.FastPlanarQuadPolicyRollout
    fp = engine(env, B, T, mlp_hidden=H, mlp_act="tanh", device=dev)
    w = common.make_weights(SEED, 6, 2, H, dev)
    ac = ActorCritic(6, 2, H, "tanh")
    common.load_weights(ac, w)
    rows = fp.reset(SEED)
    if rows_fn is not None:
        rows = rows_fn(fp.params, rows)
    seed = torch.tensor([1234567], dtype=torch.int32)
    out, traj = fp.run(rows, pack_weights(ac.actor, ac.critic, ac.logstd), seed=seed)
    p = envs.params(cfg["family"], cfg["env"])
    return p, rng.env_seeds(SEED, B, dev), rows, traj, out, w, seed


def _near_limit(p, rows):
    rows = rows.clone()
    rows[PQ.rows_layout(6)["STEP"], ::2] = NEAR_LIMIT
    return rows


def _record_gap(cfg, run):
    p, es, rows, traj, out, w, seed = run
    return check.record_gap(p, "tanh", w, seed, es, rows, traj, out, cfg["program"]["rows"])


@pytest.mark.parametrize("randomized_inertia", [False, True])
def test_reset_rows_are_the_references_draws(randomized_inertia):
    cfg = _config(randomized_inertia)
    p, es, rows, *_ = _rollout(cfg)
    layout = cfg["program"]["rows"]
    # The program adds the nominal and the low bound in float32, the
    # reference in float64 before it rounds: a draw may part by an ulp.
    assert held_rows.start_gap(p, es, rows, layout) < 1e-6
    _, inert = envs.episode_draws(p, es, torch.zeros_like(es))
    torch.testing.assert_close(rows[layout["inertial"]], torch.stack([inert[0], inert[2]]),
                               rtol=1e-6, atol=0.0)
    # With the inertia randomized the held draws differ from env to env.
    assert (rows[layout["inertial"][1]].unique().numel() > 1) == randomized_inertia


@pytest.mark.parametrize("randomized_inertia", [False, True])
def test_k8_plain_follows_the_reference_across_resets(randomized_inertia):
    cfg = _config(randomized_inertia)
    run = _rollout(cfg, _near_limit)
    traj = run[3]
    done, trunc = traj[:, 6 + 2 + 1], traj[:, 6 + 2 + 2]
    assert int(trunc.sum()) >= B // 2 - 2  # the envs started near the time limit
    assert int((done - trunc).sum()) > 0  # and out-of-bound ends besides
    gap, ties = _record_gap(cfg, run)
    assert gap < SOUND_GAP and ties == 0, gap


def _thrusts_swapped(monkeypatch):
    """The thrust difference's sign: the pitch acceleration flips (the
    action cost, a sum of squares, does not move)."""
    orig = PQ.step_rows

    def step_rows(p, carry, thrust_rows, act_rows, noise_u=None):
        return orig(p, carry, thrust_rows[::-1], act_rows, noise_u)

    monkeypatch.setattr(PQ, "step_rows", step_rows)


def _iyy_from_the_dropped_draw(monkeypatch):
    """Iyy's row read at the reset from draw 1 (Ixx, which the planar body
    drops) in place of draw 2."""
    orig = PQ.reset_rows

    def reset_rows(p, env_seeds):
        rows = orig(p, env_seeds)
        es = env_seeds.to(torch.int32)
        u = ctr_prng.slot_uniform(ctr_prng.episode_base(es, torch.zeros_like(es)), 1)
        nm, lo, hi = p["rand_nominal"][1], p["rand_lo"][1], p["rand_hi"][1]
        rows[PQ.rows_layout(6)["IYY"]] = nm + lo + u * (hi - lo)
        return rows

    monkeypatch.setattr(PQ, "reset_rows", reset_rows)


@pytest.mark.parametrize("fault", [_thrusts_swapped, _iyy_from_the_dropped_draw])
def test_planted_fault_is_caught(fault, monkeypatch):
    """Each fault in the program's plain K8 path reads over
    ``FAULT_GAP``: the swapped thrusts in the record, the dropped draw at the
    start (with the inertia randomized: in the cell's configuration Ixx
    and Iyy are both the nominal 1.4e-5, and the two draws agree)."""
    cfg = _config(randomized_inertia=True)
    fault(monkeypatch)
    run = _rollout(cfg)
    p, es, rows = run[:3]
    start = held_rows.start_gap(p, es, rows, cfg["program"]["rows"])
    gap, _ = _record_gap(cfg, run)
    assert max(start, gap) > FAULT_GAP, (start, gap)


def test_ppo_first_train_steps_follow_the_reference():
    """The train driver's Job on this configuration (PPO with
    ``use_fast_rollout=True``: K8's plain path, K4's CPU path) against
    ``reference/ppo.py::TrainJob`` within ``TRAIN_LIMITS``."""
    cell = harness.Cell(name="quad2d_stab_ppo.train_small", config=_config(),
                        traffic={"driver": "train", "num_envs": 32, "rollout_steps": 16,
                                 "minibatches": 4, "check_steps": 3, "trace_units": 1,
                                 "cpu_units": 1},
                        limits={"limits": TRAIN_LIMITS}, end_to_end=[], per_layer=[], chips=1,
                        units={})
    res, numbers = harness.run_cell(cell, SEED, 1.0, False, torch.device("cpu"),
                                    time.perf_counter())
    assert res["correct"], numbers
    assert max(numbers.values()) < 1e-5, numbers


def test_family_takes_the_pair_only_where_it_cannot_be_mistaken():
    """``advance``'s inertia: the four draws give (mass, Iyy); the pair is
    taken as (mass, Iyy) where Ixx and Iyy are drawn alike, and refused
    where they are not (a pair zipped with a reset's draws holds Ixx)."""
    from portbench.families import quad2d

    draws = [torch.tensor([float(k)]) for k in range(4)]
    pair = draws[:2]
    for randomized in (False, True):
        p = envs.params("quad2d", _config(randomized)["env"])
        assert quad2d.mass_iyy(p, draws) == (draws[0], draws[2])
        if randomized:
            with pytest.raises(ValueError):
                quad2d.mass_iyy(p, pair)
        else:
            assert quad2d.mass_iyy(p, pair) == (pair[0], pair[1])
        with pytest.raises(ValueError):
            quad2d.mass_iyy(p, draws[:3])


def test_family_imports_nothing_of_the_program_or_jax():
    banned = {"safe_control_gym_torch", "safe_control_gym_tpu", "jax", "jaxlib", "flax"}
    for path in FAMILY_FILES:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] in banned for n in names), (path.name, names)
    code = ("import sys; sys.path.insert(0, %r); from portbench import families; "
            "families.load('quad2d'); import portbench.reference.held_rows; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))") % (str(ROOT), banned)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_configuration_states_the_programs_rows():
    """The configuration's row layout is the program's, and each held row
    names its own draw."""
    cfg = json.loads((ROOT / "portbench" / "configs" / "quad2d_stab_ppo.json").read_text())
    L, rows = PQ.rows_layout(6), cfg["program"]["rows"]
    assert (rows["step"], rows["episode"], rows["seed"]) == (L["STEP"], L["EP"], L["SEED"])
    assert rows["inertial"] == [L["MASS"], L["IYY"]] and rows["inertial_draws"] == [0, 2]
    assert held_rows.held_draws(rows) == [0, 2]
    for bad in ({"inertial": [6, 6], "inertial_draws": [0, 2]},
                {"inertial": [6, 7], "inertial_draws": [2, 2]},
                {"inertial": [6, 7], "inertial_draws": [0]}):
        with pytest.raises(ValueError):
            held_rows.held_draws(bad)
