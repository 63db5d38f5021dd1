#!/usr/bin/env python3
"""Time PPO's train step on the card on each update path that builds its
minibatches in ``PPO._minibatches``, one JSON line.

Paths, all on config 4 with the normalized action space at the rl_train
shapes of ``chip_smoke.py`` (4,096 envs x 128 steps, 10 epochs of 4
minibatches of 131,072, hidden 64) unless said otherwise:

- ``separate``, ``fused``: the autograd update and the fused autograd update
  (``use_fast_update=False``), one shuffle of 256-sample blocks a step
  (``reshuffle_each_epoch=False``), K3 collecting;
- ``k4_blocks``: K4, the same one shuffle; ``k4_epochs``: K4, a shuffle an
  epoch;
- ``safe_explorer``: SafeExplorerPPO on config 4 with its defaults (4 envs x
  100 steps, 6 minibatches of 64: K4 at mb = 64), after ``pretrain()``;
- ``data_parallel``: ``distributed.sharded_train_step`` in a one-rank NCCL
  group (the general engine collecting, K4 on the rank's column share).

Each path runs ``--warmup`` train steps, then ``--steps`` more, each timed on
the host from a synchronized start to a synchronized end.  The line holds
each path's step times (ms) and their median, with the card's name and power
limit.  Without ``--ab`` the script imports nothing that is new in the
trainer, so the same file times an older checkout of the repo when copied
into it.  With ``--ab`` each K4 path alternates, in one process, steps whose
minibatches come from the layout kernel with steps whose minibatches come
from its plain version (``fast_update.minibatch_layout_plain``: the row
gather and the transpose copy of the older trainer), ``--steps`` of each in
the order kernel, plain, plain, kernel, ...; the other paths are skipped.

    python3 scripts/train_paths_port.py [--steps 5] [--ab] [--out results/train_paths.json]

Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TRAIN_B, TRAIN_T, EPOCHS, HIDDEN = 4096, 128, 10, 64
MB = TRAIN_B * TRAIN_T // 4
PATHS = ("separate", "fused", "k4_blocks", "k4_epochs", "safe_explorer", "data_parallel")


def timed(step, warmup, steps):
    """Host ms of each of ``steps`` synchronized calls after ``warmup``."""
    import torch

    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return ms


def ab_timed(step, warmup, steps):
    """Host ms of ``steps`` steps with the layout kernel and ``steps`` with
    its plain version, alternated kernel, plain, plain, kernel, ..."""
    from safe_control_gym_torch.controllers import ppo as ppo_module
    from safe_control_gym_torch.parallel import fast_update as U

    use = {"kernel": ppo_module.minibatch_layout, "plain": U.minibatch_layout_plain}
    order = [("kernel", "plain", "plain", "kernel")[i % 4] for i in range(2 * steps)]
    ms = {"kernel": [], "plain": []}
    try:
        for tag in ("kernel", "plain"):
            ppo_module.minibatch_layout = use[tag]
            timed(step, warmup, 0)
        for tag in order:
            ppo_module.minibatch_layout = use[tag]
            ms[tag] += timed(step, 0, 1)
    finally:
        ppo_module.minibatch_layout = use["kernel"]
    return ms


def path_step(path, dev):
    """A fresh controller for ``path`` and a function that runs one of its
    train steps."""
    from safe_control_gym_torch.baseline import cfg4
    from safe_control_gym_torch.controllers.ppo import PPO
    from safe_control_gym_torch.controllers.safe_explorer import SafeExplorerPPO
    from safe_control_gym_torch.envs.quadrotor import make_quadrotor

    if path == "safe_explorer":
        agent = SafeExplorerPPO(make_quadrotor(cfg4(), device=dev), seed=0)
        agent.pretrain()
    else:
        env = make_quadrotor(cfg4(normalized_rl_action_space=True), device=dev)
        kw = dict(seed=0, rollout_batch_size=TRAIN_B, rollout_steps=TRAIN_T, opt_epochs=EPOCHS,
                  mini_batch_size=MB, hidden_dim=HIDDEN)
        if path in ("separate", "fused"):
            kw.update(use_fast_rollout=True, use_fast_update=False,
                      fused_update=path == "fused", reshuffle_each_epoch=False)
        elif path == "data_parallel":
            kw.update(use_fast_rollout=False)
        else:
            kw.update(use_fast_rollout=True, reshuffle_each_epoch=path == "k4_epochs")
        agent = PPO(env, **kw)
    if path == "data_parallel":
        from safe_control_gym_torch.parallel import distributed as D

        mesh = D.host_mesh()
        holder = {"state": D.shard_ppo_state(agent, mesh)}

        def step():
            holder["state"], _ = D.sharded_train_step(agent, holder["state"], mesh)
        return agent, step

    def step():
        agent.state, _ = agent._train_step(agent.state)
    return agent, step


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--ab", action="store_true",
                    help="K4 paths only: the layout kernel against its plain version in turns")
    ap.add_argument("--out", default="results/train_paths.json")
    args = ap.parse_args()
    import torch
    import torch.distributed as dist

    from safe_control_gym_torch.parallel import distributed as D

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    out = {"card": card, "torch": torch.__version__, "root": ROOT, "paths": {}}
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one rank: loopback only
    for path in args.paths.split(","):
        if path not in PATHS:
            raise SystemExit(f"unknown path {path!r}; paths are {PATHS}")
        if args.ab and path in ("separate", "fused"):
            continue
        with tempfile.TemporaryDirectory() as tmp:
            if path == "data_parallel":
                D.initialize(f"file://{tmp}/store", world_size=1, rank=0, device=dev, timeout=300)
            try:
                agent, step = path_step(path, dev)
                ms = (ab_timed(step, args.warmup, args.steps) if args.ab else
                      {"": timed(step, args.warmup, args.steps)})
            finally:
                if dist.is_initialized():
                    dist.destroy_process_group()
        res = {"mini_batch_size": agent.cfg.mini_batch_size,
               "reshuffle_each_epoch": agent.cfg.reshuffle_each_epoch,
               "fast_update": agent._fu is not None}
        for tag, v in ms.items():
            key = f"_{tag}" if tag else ""
            res[f"ms{key}"], res[f"median_ms{key}"] = v, statistics.median(v)
            print(f"{path}{' ' + tag if tag else ''}: median {statistics.median(v):.2f} ms a "
                  f"train step ({[round(m, 2) for m in v]})", file=sys.stderr, flush=True)
        out["paths"][path] = res
        del agent, step
        torch.cuda.empty_cache()
    line = json.dumps(out)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
