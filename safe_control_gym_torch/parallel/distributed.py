"""Multi-process execution: the process group, the 2D (host, chip) mesh,
rank-local env construction, the data-parallel PPO train step, and a
launcher that starts a cluster of ranks on one machine.

Port of ``safe_control_gym_tpu/parallel/distributed.py``.  Where the JAX
package forms a ``jax.distributed`` group and runs one SPMD program over a
mesh of devices, the port runs one process (rank) per shard in a
``torch.distributed`` group:

- :func:`initialize` forms the group (``dist.init_process_group``) from its
  arguments, from ``SCG_INIT_METHOD`` (set by :func:`launch_workers`), or
  from torchrun's ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``;
- :func:`host_mesh` lays the ranks out on a 2D (host, chip) mesh, host-major,
  so that a host's ranks are adjacent and hold adjacent env ranges;
- :func:`sharded_init_fn` resets only this rank's envs, with the per-env
  seeds of the global batch (``ctr_prng.env_seeds_from_seed(seed,
  num_envs)[start:start + count]``), so every layout of ranks gives the
  one-process trajectories env for env: the general engine's reset and
  noise draws are keyed on (env seed, episode index);
- :func:`sharded_train_step` is one PPO train step with the envs split over
  the ranks (the JAX package's GSPMD train step on a sharded env state);
- :func:`launch_workers` starts ``processes x devices_per_process`` ranks of
  a worker module on this machine.

The rollout itself is ``rollout.sharded_rollout_fn``.

Backends (:func:`backend_for`): NCCL on CUDA at one rank per card; gloo on
the CPU; gloo with CUDA tensors where several ranks share one card, which
NCCL refuses ("Duplicate GPU detected"); ``parallel/mesh.py`` stages those
collectives through host memory.  Asking for NCCL with more ranks on a
machine than CUDA devices raises; nothing falls back silently.

Every function works in one process with no group formed, as the JAX
helpers do on one device: the mesh has one rank, shards are the whole
batch, and collectives are skipped.
"""

from __future__ import annotations

import contextlib
import datetime
import fcntl
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from safe_control_gym_torch.ops import ctr_prng
from safe_control_gym_torch.parallel.mesh import (
    Mesh, all_gather_cat, all_reduce_sum, broadcast_, mesh_over_ranks, shard_batch, shard_slice)
from safe_control_gym_torch.parallel.rollout import EpisodeStats, RolloutCarry
from safe_control_gym_torch.utils.device import resolve_device

HOST_AXIS = "host"
CHIP_AXIS = "chip"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def backend_for(device, ranks_on_machine: int, backend: Optional[str] = None) -> str:
    """The backend of a group whose ranks compute on ``device``: NCCL where
    each of this machine's ranks has a CUDA device of its own, else gloo
    (the CPU; or ranks that share a card).  An explicit ``backend="nccl"``
    with more ranks on the machine than CUDA devices raises."""
    device = torch.device(device)
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 0
    if backend is None:
        backend = "nccl" if device.type == "cuda" and ranks_on_machine <= n_dev else "gloo"
    if backend == "nccl" and ranks_on_machine > n_dev:
        raise ValueError(f"NCCL takes one rank per CUDA device: {ranks_on_machine} ranks on "
                         f"{n_dev} CUDA devices ({device}); several ranks share a card "
                         "through gloo")
    return backend


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: Optional[str] = None, device=None,
               timeout: Optional[float] = None) -> torch.device:
    """Form the process group; returns the device this rank computes on.

    Arguments default to ``SCG_INIT_METHOD`` (or ``env://`` where
    ``MASTER_ADDR`` is set), ``WORLD_SIZE``, ``RANK``, ``SCG_DEVICE`` and
    ``SCG_TIMEOUT`` (seconds).  The device defaults to CUDA
    (``cuda:LOCAL_RANK`` modulo the device count), and raises without a
    card.  Forms nothing where a group exists already, or in one process
    with no init method configured.  The backend follows
    :func:`backend_for` over ``LOCAL_WORLD_SIZE`` ranks on this machine."""
    env = os.environ
    if init_method is None:
        init_method = env.get("SCG_INIT_METHOD") or ("env://" if "MASTER_ADDR" in env else None)
    world_size = int(world_size if world_size is not None else env.get("WORLD_SIZE", 1))
    rank = int(rank if rank is not None else env.get("RANK", 0))
    dev = resolve_device(device if device is not None else env.get("SCG_DEVICE"))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(env.get("LOCAL_RANK", rank)) % torch.cuda.device_count())
    if dist.is_initialized():
        return dev
    if init_method is None:
        if world_size > 1:
            raise ValueError(f"a group of {world_size} ranks needs an init method "
                             "(SCG_INIT_METHOD, or MASTER_ADDR and MASTER_PORT)")
        return dev
    backend = backend_for(dev, int(env.get("LOCAL_WORLD_SIZE", world_size)), backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    seconds = float(timeout if timeout is not None else env.get("SCG_TIMEOUT", 600))
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=seconds))
    return dev


def host_mesh(axis_names: Sequence[str] = (HOST_AXIS, CHIP_AXIS),
              devices_per_host: Optional[int] = None) -> Mesh:
    """2D (host, chip) mesh over the group's ranks, host-major: rank
    ``h * devices_per_host + c`` is chip ``c`` of host ``h``.

    ``devices_per_host`` defaults to ``SCG_DEVICES_PER_PROCESS`` (set by
    :func:`launch_workers`), else ``LOCAL_WORLD_SIZE``, else every rank on
    one host.  In one process with no group: a (1, 1) mesh."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if devices_per_host is None:
        env = os.environ
        devices_per_host = int(env.get("SCG_DEVICES_PER_PROCESS",
                                       env.get("LOCAL_WORLD_SIZE", world)))
    if world % devices_per_host:
        raise ValueError(f"{world} ranks do not split into hosts of {devices_per_host}")
    return mesh_over_ranks((world // devices_per_host, devices_per_host), axis_names)


def local_env_slice(mesh: Mesh, num_envs: int,
                    axis_names: Optional[Sequence[str]] = (HOST_AXIS, CHIP_AXIS)):
    """(start, count) of this rank's contiguous global env range; raises
    ``ValueError`` where ``num_envs`` does not split evenly."""
    return shard_slice(mesh, num_envs, axis_names)


def sharded_init_fn(env, num_envs: int, mesh: Mesh, axis_names=None,
                    stats_dtype=torch.float32) -> Callable:
    """``(seed=0, env_seeds=None) -> RolloutCarry`` of this rank's envs.

    Each rank resets only its ``num_envs / n_shards`` envs (``axis_names``:
    the mesh axes the batch splits over, default all), with the per-env
    seeds of the global batch: ``env_seeds`` ((num_envs,) int32) or
    ``ctr_prng.env_seeds_from_seed(seed, num_envs)``, the seeds
    ``make_vec_env(env, num_envs).reset`` uses, sliced to this rank's
    range.  The global set of states is then bit-equal to the one-process
    reset for any layout (the JAX package takes ``split(key,
    num_envs)[global_idx]``)."""
    start, count = shard_slice(mesh, num_envs, axis_names)

    def init(seed: int = 0, env_seeds=None) -> RolloutCarry:
        if env_seeds is None:
            env_seeds = ctr_prng.env_seeds_from_seed(seed, num_envs, env.device)
        env_seeds = torch.as_tensor(env_seeds, dtype=torch.int32, device=env.device)
        if tuple(env_seeds.shape) != (num_envs,):
            raise ValueError(f"env_seeds must have shape ({num_envs},)")
        state, obs, _ = env.reset(env_seeds[start:start + count])
        return RolloutCarry(env_state=state, obs=obs, policy_state=(),
                            stats=EpisodeStats.create(count, stats_dtype, env.device))

    return init


# -- data-parallel PPO --------------------------------------------------------
class _DataParallel:
    """``PPO.data_parallel`` for one sharded train step over ``n`` equal
    shares: this rank's share of every minibatch, and the sums over the
    ranks of means taken over one share each."""

    def __init__(self, group, index: int, n: int):
        self.group, self.index, self.n = group, index, n

    def share(self, idx):
        """(n_mini, mb) sample indices of the minibatches -> this rank's
        columns (n_mini, mb / n), a view."""
        s = idx.shape[1] // self.n
        return idx[:, self.index * s:(self.index + 1) * s]

    def sync(self, grads, losses):
        """Gradients and loss means of one share each -> those of the whole
        minibatch on every rank: one all-reduce of the lot, divided by n."""
        flat = torch.cat([g.reshape(-1) for g in grads] + [losses.reshape(-1)]) / self.n
        flat = all_reduce_sum(flat, self.group)
        out, o = [], 0
        for g in grads:
            out.append(flat[o:o + g.numel()].view_as(g))
            o += g.numel()
        return out, flat[o:]

    def moments(self, mean, var, count):
        """A running normalizer's batch moments over every rank's batch
        (``RunningMeanStd.reduce``): the parallel-variance combination of
        n equal batches."""
        m = all_reduce_sum(mean / self.n, self.group)
        v = all_reduce_sum((var + (mean - m) ** 2) / self.n, self.group)
        return m, v, count * self.n


def shard_ppo_state(ppo, mesh: Mesh):
    """``ppo.state`` made a rank's state of a data-parallel run, in place:
    the env state, the observations and the reward normalizer's running
    returns cut to this rank's envs of the global batch the controller was
    built with (``rollout_batch_size``), the networks' parameters and the
    optimizers' moments broadcast from rank 0."""
    st, group = ppo.state, mesh.group()
    with torch.no_grad():
        for t in [*st.ac.parameters(), *st.actor_opt.mu, *st.actor_opt.nu,
                  *st.critic_opt.mu, *st.critic_opt.nu]:
            broadcast_(t, group)
    st.env_state = shard_batch(st.env_state, mesh, mesh.axis_names)
    st.obs = shard_batch(st.obs, mesh, mesh.axis_names)
    st.rew_norm.ret = shard_batch(st.rew_norm.ret, mesh, mesh.axis_names)
    return st


def sharded_train_step(ppo, state, mesh: Mesh, eps=None, perm=None):
    """One PPO train step with the envs split over the ranks of ``mesh``.

    ``state`` holds this rank's envs (:func:`shard_ppo_state`); every rank
    holds the same parameters.  The step:

    - collects its envs with the general engine, sampling with the normals
      of ``eps`` ((T, B, act_dim), the global table; drawn from the
      controller's generator, the same on every rank, where None), so any
      layout of ranks samples as one process given the same ``eps`` does;
    - gathers the rollout over the ranks and runs GAE and the advantage
      standardization on the global batch, as one process does;
    - steps every minibatch of the one-process permutation (``perm``, as
      ``PPO.update`` takes it; else the controller's generator) with each
      rank computing the gradients and loss sums of its 1/W share (K4 on
      the card) and one all-reduce of them before the KL gate and the two
      Adam steps (``PPO.data_parallel``);
    - takes the running normalizers' batch moments over every rank's batch.

    Parameters and Adam moments then match the one-process ``_train_step``
    to float rounding (bit for bit at world size 1).  The fast collectors
    are not sharded: K3's in-kernel noise, as K2's step noise, is keyed by
    the env's index within its launch, so its draws depend on the layout
    (as in the JAX package, which runs neither under ``shard_map``).
    Returns ``(state, metrics)``."""
    if ppo._fp is not None:
        raise ValueError("sharded_train_step collects with the general engine: the policy "
                         "kernels' noise is keyed by the env's index within a launch")
    cfg = ppo.cfg
    B, T, mb = cfg.rollout_batch_size, cfg.rollout_steps, cfg.mini_batch_size
    group = mesh.group()
    index, n = mesh.shard()
    start, count = shard_slice(mesh, B)
    if mb % n or (ppo._fu is not None and (mb // n) % 8):
        raise ValueError(f"a minibatch of {mb} does not split into {n} shares"
                         + (" of a multiple of 8 (K4)" if ppo._fu is not None else ""))
    if eps is None:
        eps = torch.randn((T, B, ppo.act_dim), generator=ppo.gen, device=ppo.device)
    dp = _DataParallel(group, index, n)
    norms = (state.obs_norm.rms, state.rew_norm.rms)
    ppo.data_parallel = dp
    for rms in norms:
        rms.reduce = dp.moments
    try:
        roll = ppo.collect(state, eps[:, start:start + count])
        with torch.no_grad():
            last_val = ppo._value(state.ac, state.obs)
        roll = {k: all_gather_cat(v, group, 1) for k, v in roll.items()}
        return ppo.update_from(state, roll, all_gather_cat(last_val, group, 0), perm)
    finally:
        ppo.data_parallel = None
        for rms in norms:
            rms.reduce = None


# -- the launcher ---------------------------------------------------------------
def _wait(procs, deadline: float, grace: float = 10.0) -> None:
    """Until every rank exits, the deadline passes, or ``grace`` seconds
    after the first rank fails (its peers may block in a collective)."""
    failed_at = None
    while time.monotonic() < deadline:
        codes = [p.poll() for p in procs]
        if all(c is not None for c in codes):
            return
        if failed_at is None and any(c not in (None, 0) for c in codes):
            failed_at = time.monotonic()
        if failed_at is not None and time.monotonic() > failed_at + grace:
            return
        time.sleep(0.05)


def launch_workers(worker: str, num_processes: int, devices_per_process: int = 1,
                   extra_args: Sequence[str] = (), timeout: float = 600.0,
                   env_overrides: Optional[dict] = None, device: str = "cpu",
                   store_dir: Optional[str] = None):
    """Start ``num_processes x devices_per_process`` ranks of ``worker`` (a
    module name, run with ``python -m``, or a ``.py`` path) on this machine
    and wait for them; returns ``[(returncode, output)]`` in rank order.

    Each rank gets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE`` (every rank is on this machine),
    ``SCG_DEVICES_PER_PROCESS`` (the chip axis of :func:`host_mesh`),
    ``SCG_DEVICE``, ``SCG_TIMEOUT`` and ``SCG_INIT_METHOD``: a ``FileStore``
    in a fresh temporary directory (under ``store_dir``, default the
    system's), so clusters never share a rendezvous (no port is bound).
    One intra-op thread a rank.  The worker calls :func:`worker_initialize`.  A rank that outlives ``timeout`` seconds, or
    that still runs 10 s after another rank failed, is killed (its return
    code is then negative).

    Clusters are started one at a time machine-wide (an ``flock`` under the
    temporary directory): two clusters on one machine oversubscribe its
    cores and starve each other past their timeouts.  The timeout counts
    from the start of this cluster, not of the wait for the lock."""
    n = num_processes * devices_per_process
    cmd = [sys.executable, worker] if worker.endswith(".py") else [sys.executable, "-m", worker]
    lock_path = os.path.join(tempfile.gettempdir(), "scg_torch_cluster.lock")
    with contextlib.ExitStack() as stack:
        lock = stack.enter_context(open(lock_path, "w"))
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        tmp = stack.enter_context(tempfile.TemporaryDirectory(prefix="scg_cluster_",
                                                              dir=store_dir))
        base = {**os.environ, **(env_overrides or {}),
                "WORLD_SIZE": str(n), "LOCAL_WORLD_SIZE": str(n),
                "SCG_DEVICES_PER_PROCESS": str(devices_per_process), "SCG_DEVICE": device,
                "SCG_TIMEOUT": str(timeout), "SCG_INIT_METHOD": f"file://{tmp}/store",
                "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
                # Every rank is on this machine: gloo connects over loopback
                # (a host name that resolves to no local address stops it).
                "GLOO_SOCKET_IFNAME": os.environ.get("GLOO_SOCKET_IFNAME", "lo"),
                "PYTHONPATH": os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH"))
                                              if p)}
        logs = [stack.enter_context(open(os.path.join(tmp, f"rank{r}.log"), "w+"))
                for r in range(n)]
        procs = []
        try:
            for r in range(n):
                procs.append(subprocess.Popen(
                    [*cmd, *extra_args], env={**base, "RANK": str(r), "LOCAL_RANK": str(r)},
                    stdout=logs[r], stderr=subprocess.STDOUT))
            _wait(procs, time.monotonic() + timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        results = []
        for p, log in zip(procs, logs):
            log.seek(0)
            results.append((p.returncode, log.read()))
    return results


def result_line(results, tag: str) -> dict:
    """The JSON of the one line starting with ``tag`` in a cluster's output;
    raises where a rank failed or the line is not there once."""
    for rank, (rc, out) in enumerate(results):
        if rc != 0:
            raise RuntimeError(f"rank {rank} of {len(results)} failed (rc={rc}):\n{out[-4000:]}")
    lines = [line[len(tag):] for _, out in results for line in out.splitlines()
             if line.startswith(tag)]
    if len(lines) != 1:
        raise RuntimeError(f"{len(lines)} lines start with {tag!r} (one expected):\n"
                           + "\n".join(out[-2000:] for _, out in results))
    return json.loads(lines[0])


def worker_initialize() -> torch.device:
    """Worker side: one intra-op thread, then join the cluster that
    :func:`launch_workers` set up in this process's environment; returns
    the rank's device."""
    torch.set_num_threads(1)
    return initialize()
