"""The comparisons that decide ``correct``, and the numbers they compare.

Train cells: the reference follows the program's first train steps from
the same weights and seed, and three numbers are compared, each the worst
case of a gap measured against the reference:

* ``loss_gap``: the first train step's loss (policy + value +
  entropy_coef x entropy, the means the step returns): the sum of the
  three terms' gaps over the sum of the reference's terms' sizes (the
  policy term is near zero by the advantages' standardization, so a term
  may cancel another).  The later steps' losses spread from seed to seed
  with the rollouts' round-off, grown through the updates; the first
  step's does not.
* ``grad_norm_gap``: each leaf's norm of the gradient the optimizer took
  at its first step (read back from its first moment), the gap between
  the two norms over the larger of the reference leaf's norm and the
  median leaf's.
* ``change_norm_gap``: each leaf's norm of the change of the parameters
  over the followed steps, measured the same way; leaves whose first
  gradient in the reference is under a thousandth of the median leaf's
  (round-off only) are left out.

Collect cells: ``record_gap``, the widest gap ``|program - reference| /
max(1, |reference|)`` over every entry of the sampled calls' records: the
start state against the reference's reset, and at every step from the
program's own state the policy's action, log-probability and value, the
reward, done, truncation, the terminal observation and the next state
(after an auto-reset: the reference's reset draws).  A done flag whose
out-of-bound test lies within ``TIE`` of its bound in the reference is a
tie that rounding decides: that step's flag and what follows from it are
not compared.
"""

from __future__ import annotations

import statistics

import torch

from portbench.reference import envs, policy, ppo, rng

LOSS_KEYS = ("policy_loss", "value_loss", "entropy_loss", "approx_kl")
ROUND_OFF_LEAF = 1e-3
TIE = 1e-5


def train_reference(cell, w0, seed, device, steps, precision="float32", fault=None):
    """What the reference observes over the first ``steps`` train steps."""
    cfg, tr = cell.config, cell.traffic
    B, T = int(tr["num_envs"]), int(tr["rollout_steps"])
    job = ppo.TrainJob(cfg["family"], cfg["env"], cfg["ppo"], w0, seed, B, T,
                       B * T // int(tr["minibatches"]), device, precision, fault)
    losses = [job.train_step() for _ in range(steps)]
    return {"losses": losses, "first": job.first_grads, "w0": w0, "wn": job.w}


def _norms(d):
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def train_numbers(a, ref, ppo_cfg):
    """The three numbers of observation ``a`` against the reference's."""
    c = ppo_cfg["entropy_coef"]

    def gap(x, r):
        w = (1.0, 1.0, c)
        return (sum(wi * abs(float(xi) - float(ri)) for wi, xi, ri in zip(w, x, r))
                / sum(wi * abs(float(ri)) for wi, ri in zip(w, r)))

    loss_gap = gap(a["losses"][0], ref["losses"][0])
    ga, gr = _norms(a["first"]), _norms(ref["first"])
    med = statistics.median(gr.values())
    # An optimizer that never stepped took no gradient: norm 0.
    grad_gap = max(abs(ga.get(k, 0.0) - gr[k]) / max(gr[k], med) for k in policy.LEAVES)
    counted = [k for k in policy.LEAVES if gr[k] >= ROUND_OFF_LEAF * med]
    da = _norms({k: a["wn"][k] - a["w0"][k] for k in counted})
    dr = _norms({k: ref["wn"][k] - ref["w0"][k] for k in counted})
    medd = statistics.median(dr.values())
    change_gap = max(abs(da[k] - dr[k]) / max(dr[k], medd) for k in counted)
    return {"loss_gap": loss_gap, "grad_norm_gap": grad_gap, "change_norm_gap": change_gap}


def _gap(x, r):
    return float(((x - r).abs() / torch.clamp(r.abs(), min=1.0)).max()) if x.numel() else 0.0


def _exclusive_cumsum(x):
    return torch.cumsum(x, 0) - x


@torch.no_grad()
def record_gap(p, act_name, w, call_seed, env_seed, rows_in, traj, rows_out, layout):
    """``record_gap`` of one policy-kernel call: ``rows_in``/``rows_out`` the
    program's rows before and after it, ``traj`` its record (T, 2 D + nu +
    5, B); ``layout`` the program's row indices (``step``, ``episode``)."""
    nx, nu = p["nx"], p["nu"]
    T, _, B = traj.shape
    obs = traj[:, :nx]
    act = traj[:, nx:nx + nu]
    rew, done, trunc, v, logp = (traj[:, nx + nu + k] for k in range(5))
    term = traj[:, nx + nu + 5:2 * nx + nu + 5]
    done_b = done > 0.5
    t_idx = torch.arange(T, device=traj.device)[:, None].expand(T, B)
    ep0 = rows_in[layout["episode"]].to(torch.int64)[None]
    ep = ep0 + _exclusive_cumsum(done_b.to(torch.int64))
    last = torch.where(done_b, t_idx, torch.full_like(t_idx, -1))
    last = torch.cummax(last, 0).values
    last_excl = torch.cat([torch.full_like(last[:1], -1), last[:-1]], 0)
    step0 = rows_in[layout["step"]][None]
    step_f = torch.where(last_excl < 0, step0 + t_idx.to(torch.float32),
                         (t_idx - last_excl - 1).to(torch.float32))
    es = env_seed[None].expand(T, B).reshape(-1)
    env = torch.arange(B, device=traj.device)[None].expand(T, B).reshape(-1)
    flat = lambda x: x.reshape(-1)  # noqa: E731
    obs_f = obs.permute(0, 2, 1).reshape(-1, nx)
    mean, v_ref = policy.forward(w, obs_f, act_name, "float32")
    act_ref, logp_ref = policy.sample(mean, w["logstd"], call_seed, flat(t_idx), env)
    gaps = [_gap(act.permute(0, 2, 1).reshape(-1, nu), act_ref), _gap(flat(v), v_ref),
            _gap(flat(logp), logp_ref)]
    _, inert = envs.episode_draws(p, es, flat(ep))
    s_post, rew_r, done_r, trunc_r, margin = envs.step(
        p, list(obs_f.T), inert, flat(step_f), list(act.permute(1, 0, 2).reshape(nu, -1)))
    tie = (done_r != flat(done_b)) & (margin < TIE)
    ok = ~tie
    s_reset, _ = envs.episode_draws(p, es, flat(ep) + 1)
    nxt_ref = torch.stack([torch.where(done_r, a, b) for a, b in zip(s_reset, s_post)], 1)
    nxt = torch.cat([obs[1:], rows_out[None, :nx]], 0).permute(0, 2, 1).reshape(-1, nx)
    term_ref = torch.stack(s_post, 1) * trunc_r[:, None].to(torch.float32)
    gaps += [_gap(flat(rew)[ok], rew_r[ok]), _gap(flat(done)[ok], done_r[ok].to(torch.float32)),
             _gap(flat(trunc)[ok], trunc_r[ok].to(torch.float32)),
             _gap(term.permute(0, 2, 1).reshape(-1, nx)[ok], term_ref[ok]),
             _gap(nxt[ok], nxt_ref[ok])]
    return max(gaps), int(tie.sum())


@torch.no_grad()
def start_gap(p, env_seed, rows, layout):
    """The program's reset rows against the reference's episode-0 draws:
    state, inertia, step and episode counters, and the seed's bits."""
    ep0 = torch.zeros_like(env_seed)
    s, inert = envs.episode_draws(p, env_seed, ep0)
    gaps = [_gap(rows[:p["nx"]], torch.stack(s)),
            _gap(rows[layout["inertial"]], torch.stack(inert)),
            _gap(rows[layout["step"]], torch.zeros_like(rows[0])),
            _gap(rows[layout["episode"]], torch.zeros_like(rows[0]))]
    bits = rows[layout["seed"]].contiguous().view(torch.int32).to(torch.int64) & rng.U32
    return max(gaps + [float((bits != env_seed).any())])
