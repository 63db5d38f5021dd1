"""The readings that a cell's limits are set from, at the cell's own size.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 --out chiprun_out/calibrate.json

For each seed the program runs its set-up as a benchmark run does (train:
its first ``check_steps`` train steps; collect: the first call and the
sampled calls), its state is freed and the reference judges it: the lower
readings.  On the control seeds the control is judged the same way in the
program's place: the reference computed with TF32 products (train: the
whole followed steps; collect: each sampled call's rollout from the
program's rows at its start), and for train cells the faults a training
check must catch (half of each minibatch left out, the first step's
rewards zeroed), each planted in the reference put in the program's place.
A state left unchanged reads 1 on ``change_norm_gap`` and needs no run.
The benchmark's own runs never run this script.

A cell on several cards runs through the same ranks as ``run.py``
(``ranks.py``), one process a card: for each seed every rank builds its
``Job`` and makes the same calls; rank 0 reads as above, the other ranks
run ``run.py``'s check, and rank 0 keeps the worst reading of each number
over the ranks.  The control and the faults are rank 0's alone.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def record_of(recs):
    """The program's record layout (T, 2 D + nu + 5, B) from a reference
    rollout's records."""
    import torch

    cols = [recs["obs"].transpose(1, 2), recs["act"].transpose(1, 2)]
    cols += [recs[k][:, None] for k in ("rew", "done", "trunc", "v", "logp")]
    return torch.cat(cols + [recs["term"].transpose(1, 2)], 1)


def collect_control(job, precision="tf32"):
    """The control's record_gap: each kept call rolled out by the reference
    in ``precision`` from the program's rows at the call's start."""
    import torch

    from portbench.reference import check, envs, ppo, rng

    cfg = job.cell.config
    p = envs.params(cfg["family"], cfg["env"])
    lay = cfg["program"]["rows"]
    es = rng.env_seeds(job.seed, job.B, job.device)
    gap = 0.0
    for k, (rows_in, _, _) in sorted(job.kept.items()):
        batch = ppo.EnvBatch(list(rows_in[:p["nx"]]), list(rows_in[lay["inertial"]]),
                             rows_in[lay["step"]].clone(), rows_in[lay["episode"]].to(torch.int64),
                             es)
        recs, after = ppo.rollout(p, cfg["ppo"]["activation"], job.w0, job.seeds[k], batch,
                                  job.T, precision)
        rows_out = rows_in.clone()
        rows_out[:p["nx"]] = torch.stack(after.s)
        g, _ = check.record_gap(p, cfg["ppo"]["activation"], job.w0, job.seeds[k], es, rows_in,
                                record_of(recs), rows_out, lay)
        gap = max(gap, g)
    return {"record_gap": gap}


def first_rollout_look(job, seed):
    """The program's first rollout against the reference's from the same
    reset, weights and call seed: done flags that differ, envs whose
    records part by more than 1e-3, and the largest difference."""
    import torch

    from portbench.drivers import common
    from portbench.reference import envs, ppo, rng
    from safe_control_gym_torch.controllers.ppo import ActorCritic
    from safe_control_gym_torch.parallel.fast_policy import pack_weights

    cfg, dev = job.cell.config, job.device
    fp = job.ppo._fp
    ac = ActorCritic(fp.obs_dim, job.ppo.act_dim, int(cfg["ppo"]["hidden_dim"]),
                     cfg["ppo"]["activation"]).to(dev)
    common.load_weights(ac, job.w0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    call_seed = torch.randint(0, 2**31 - 1, (1,), generator=gen, device=dev, dtype=torch.int32)
    _, traj = fp.run(fp.reset(seed), pack_weights(ac.actor, ac.critic, ac.logstd), seed=call_seed)
    p = envs.params(cfg["family"], cfg["env"])
    recs, _ = ppo.rollout(p, cfg["ppo"]["activation"], job.w0, call_seed,
                          ppo.reset(p, rng.env_seeds(seed, job.B, dev)), job.T, "float32")
    ref = record_of(recs)
    d = p["nx"] + p["nu"] + 1
    diff = (traj - ref).abs()
    return {"done_flags_differ": int((traj[:, d] != ref[:, d]).sum()),
            "envs_parted": int((diff.amax(dim=(0, 1)) > 1e-3).sum()),
            "max_diff": float(diff.max()), "episodes_ended": int(ref[:, d].sum())}


def summary(obs):
    """An observation's raw readings: each step's four losses, each leaf's
    first-gradient norm and change norm."""
    import torch

    def norm(t):
        return float(torch.linalg.vector_norm(t.double()))

    return {"losses": [[float(x) for x in m] for m in obs["losses"]],
            "first": {k: norm(v) for k, v in obs["first"].items()},
            "change": {k: norm(obs["wn"][k] - obs["w0"][k]) for k in obs["wn"]}}


def write(out, path):
    """The lower reading (the largest over seeds) and the control's (the
    smallest) of each number, then every reading, to ``path``."""
    for part in ("lower", "control"):
        keys = sorted({k for v in out[part].values() for k in v})
        agg = max if part == "lower" else min
        out[part + "_reading"] = {k: agg(v[k] for v in out[part].values()) for k in keys}
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(out, indent=1))
    print(json.dumps({"lower_reading": out["lower_reading"],
                      "control_reading": out["control_reading"]}))


def main(argv=None, device_type: str = "cuda"):
    """``device_type="cpu"`` (the tests) runs a cell on several cards as
    ranks on the CPU in a gloo group."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", required=True)
    # A rank above 0 of a cell on several cards, started by rank 0 (ranks.py).
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--store", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness, ranks
    from portbench.reference import check

    cell = harness.resolve(args.workload)
    harness.exact_products()
    group = None
    if cell.chips > 1:
        group = ranks.Group(cell.chips, rank=args.rank, store_path=args.store,
                            script=Path(__file__).resolve(),
                            argv=["--workload", args.workload, "--seeds", args.seeds,
                                  "--control-seeds", args.control_seeds, "--out", args.out],
                            device_type=device_type)
    lead = group is None or group.rank == 0
    with group or contextlib.nullcontext():
        device = group.device if group else torch.device(device_type)
        Job = harness.driver(cell).Job
        seeds = [int(s) for s in args.seeds.split(",") if s]
        controls = {int(s) for s in args.control_seeds.split(",") if s}
        out = {"workload": args.workload, "lower": {}, "control": {}, "faults": {},
               "seconds": {}, "raw": {}}
        train = "check_steps" in cell.traffic
        for seed in seeds:
            if group:
                group.arm(ranks.CALIBRATE_SEED_S, f"seed {seed}")
            t0 = time.perf_counter()
            job = Job(cell, seed, device)
            look = first_rollout_look(job, seed) if train and lead else None
            if not train:
                for _ in range(int(cell.traffic["sample_range"])):
                    job.unit()
            job.free()
            t1 = time.perf_counter()
            if train and lead:
                ref = check.train_reference(cell, job.w0, seed, device, len(job.losses))
                numbers = check.train_numbers(job.observed(), ref, cell.config["ppo"])
                out["raw"][seed] = {"program": summary(job.observed()),
                                    "reference": summary(ref), "first_rollout": look}
            else:
                # run.py's check: on every rank where the cell runs on several.
                numbers = job.check()
                if hasattr(job, "ties"):
                    numbers["tied_steps"] = job.ties
            if group:
                # The worst reading of each number over the ranks, as run.py's.
                numbers = group.gather(f"check/{seed}", ranks.plain(numbers))
                numbers = ranks.merge(numbers) if lead else None
            if lead:
                out["lower"][seed] = numbers
                out["seconds"][seed] = {"program": t1 - t0, "check": time.perf_counter() - t1}
            if lead and seed in controls:
                if train:
                    steps = len(job.losses)
                    ctrl = check.train_reference(cell, job.w0, seed, device, steps, "tf32")
                    out["control"][seed] = check.train_numbers(ctrl, ref, cell.config["ppo"])
                    out["raw"][seed]["control"] = summary(ctrl)
                    out["faults"][seed] = {}
                    for fault in ("half_batch", "reward_t0"):
                        obs = check.train_reference(cell, job.w0, seed, device, steps,
                                                    fault=fault)
                        out["faults"][seed][fault] = check.train_numbers(obs, ref,
                                                                         cell.config["ppo"])
                        out["raw"][seed][fault] = summary(obs)
                else:
                    out["control"][seed] = collect_control(job)
            if lead:
                print(json.dumps({"seed": seed, "lower": out["lower"][seed],
                                  "control": out["control"].get(seed),
                                  "faults": out["faults"].get(seed),
                                  "seconds": out["seconds"][seed], "look": look}),
                      flush=True)
            del job
            if group:
                group.barrier(f"done/{seed}")
    if lead:
        write(out, args.out)


if __name__ == "__main__":
    main()
