"""The trainer's minibatch layout (``controllers/ppo.py::_block_index`` and
``_minibatches``, ``parallel/fast_update.py::minibatch_layout``): the
sample indices of each shuffle and K4's batch-last minibatches built from
them, against the gather and transpose the trainer ran before
(``packed[p[:take]].reshape(n_mini, mb, -1).transpose(1, 2).contiguous()``),
on the CPU (the plain version) and on a card (the kernel, which must give
the same bits).

This file imports no JAX, so that the card's machine, which has none, runs
it: ``python3 -m pytest --noconftest tests/test_torch_minibatch_layout.py``.
"""

import json
import os
import types

import pytest
import torch

from safe_control_gym_torch.controllers.ppo import PPO, _BLK
from safe_control_gym_torch.envs import quadrotor as tq
from safe_control_gym_torch.parallel import fast_update as tfu
from safe_control_gym_torch.parallel.distributed import _DataParallel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUAD = dict(quad_type=3, ctrl_freq=60, pyb_freq=240, episode_len_sec=0.25,
            task="stabilization", cost="rl_reward", randomized_init=True,
            normalized_rl_action_space=True)


def _ppo(device="cpu", **kw):
    """A PPO on the 3D quadrotor whose update takes K4 (its plain version on
    the CPU); F = 12 + 4 + 4 = 20."""
    return PPO(tq.make_quadrotor(tq.QuadrotorConfig(**QUAD), device=device), seed=5,
               use_fast_update=True, **kw)


def _old_blocks(packed, mb, perm, blocks):
    """The parent's minibatches of one shuffle, (n_mini, mb, F) rows."""
    N = packed.shape[0]
    n_mini = max(N // mb, 1)
    if blocks:
        return packed.reshape(N // _BLK, -1)[perm].reshape(n_mini, mb, -1)
    return packed[perm[:n_mini * mb]].reshape(n_mini, mb, -1)


def _old_update(self, state, batch, perm=None):
    """``PPO.update`` as it was: a row gather, this rank's rows of it, then
    the transpose copy for K4, for every shuffle."""
    cfg = self.cfg
    cols = [batch[f].reshape(-1, *batch[f].shape[2:])
            for f in ("obs", "act", "v", "logp", "ret", "adv")]
    packed = torch.cat([c[:, None] if c.dim() == 1 else c for c in cols], 1).to(torch.float32)
    N, mb = packed.shape[0], cfg.mini_batch_size
    n_mini = max(N // mb, 1)

    def layout(mbs):
        if self.data_parallel is not None:
            s = mbs.shape[1] // self.data_parallel.n
            mbs = mbs[:, self.data_parallel.index * s:(self.data_parallel.index + 1) * s]
        return mbs if self._fu is None else mbs.transpose(1, 2).contiguous()

    blocks = None
    if not cfg.reshuffle_each_epoch:
        blk = N == n_mini * mb and N % _BLK == 0 and mb % _BLK == 0
        if perm is None:
            perm = torch.randperm(N // _BLK if blk else N, generator=self.gen, device=self.device)
        blocks = layout(_old_blocks(packed, mb, perm, blk))
    epochs = []
    for e in range(cfg.opt_epochs):
        if cfg.reshuffle_each_epoch:
            p = perm[e] if perm is not None else torch.randperm(N, generator=self.gen,
                                                                device=self.device)
            blocks = layout(packed[p[:n_mini * mb]].reshape(n_mini, mb, -1))
        epochs.append(torch.stack([self.minibatch_step_kernel(state, blocks[i])
                                   for i in range(n_mini)]).mean(0))
    m = torch.stack(epochs).mean(0)
    return {"policy_loss": m[0], "value_loss": m[1], "entropy_loss": m[2], "approx_kl": m[3]}


# (N, mini_batch_size, reshuffle_each_epoch): the per-epoch path with
# take == N and take < N, one minibatch, and the one-shuffle path over
# 256-sample blocks and, where shapes refuse blocks, over samples.
CASES = {"epoch": (1024, 256, True), "take<N": (1000, 256, True), "n_mini=1": (300, 256, True),
         "blocks": (1024, 512, False), "no-blocks": (1000, 256, False)}


@pytest.mark.parametrize("ranks", [1, 2], ids=["one-rank", "two-rank-share"])
@pytest.mark.parametrize("case", list(CASES))
def test_index_and_layout_match_the_old_gather(case, ranks):
    """The index of each shuffle and the blocks the trainer hands K4 equal
    the parent's gather and transpose of the same permutation; under data
    parallelism each rank's blocks (a column slice of the index) equal its
    share of the gathered rows."""
    N, mb, reshuffle = CASES[case]
    ppo = _ppo(rollout_batch_size=4, rollout_steps=4, mini_batch_size=mb,
               reshuffle_each_epoch=reshuffle)
    gen = torch.Generator().manual_seed(N + mb)
    packed = torch.randn(N, 20, generator=gen)
    n_mini = max(N // mb, 1)
    blocks = not reshuffle and N % _BLK == 0 and mb % _BLK == 0 and n_mini * mb == N
    perm = torch.randperm(N // _BLK if blocks else N, generator=gen)
    if reshuffle:
        idx = perm[:n_mini * mb].reshape(n_mini, mb)
    else:
        idx = ppo._block_index(N, perm)
    old = _old_blocks(packed, mb, perm, blocks)
    assert idx.shape == (n_mini, mb) and torch.equal(packed[idx], old)
    for r in range(ranks):
        s = mb // ranks
        want = old[:, r * s:(r + 1) * s].transpose(1, 2).contiguous()
        ppo.data_parallel = _DataParallel(None, r, ranks) if ranks > 1 else None
        got = ppo._minibatches(packed, idx)
        assert got.shape == (n_mini, 20, s) and got.is_contiguous()
        assert torch.equal(got, want)
        assert torch.equal(tfu.minibatch_layout(packed, idx[:, r * s:(r + 1) * s]), want)


def _state_leaves(ppo):
    st = ppo.state
    return ([p.detach().clone() for p in st.ac.parameters()]
            + [t.clone() for opt in (st.actor_opt, st.critic_opt) for t in (*opt.mu, *opt.nu)])


def _step_pair(make, steps=1):
    """Parameters, Adam moments and loss means after ``steps`` train steps
    of two controllers made alike, one through the helper and one through
    the parent's update."""
    out = []
    for old in (False, True):
        ppo = make()
        if old:
            ppo.update = types.MethodType(_old_update, ppo)
        for _ in range(steps):
            ppo.state, metrics = ppo._train_step(ppo.state)
        out.append((_state_leaves(ppo), torch.stack([metrics[k] for k in sorted(metrics)])))
    return out


@pytest.mark.parametrize("reshuffle", [True, False], ids=["per-epoch", "one-shuffle-blocks"])
def test_train_step_bit_equal_to_the_old_layout(reshuffle):
    """Two train steps through the helper leave the parameters, both
    optimizers' moments and the loss means bit for bit where the parent's
    gather and transpose leave them (K4's plain version on the CPU)."""
    (new, m_new), (old, m_old) = _step_pair(
        lambda: _ppo(rollout_batch_size=32, rollout_steps=16, mini_batch_size=_BLK,
                     opt_epochs=2, reshuffle_each_epoch=reshuffle, use_fast_rollout=True), 2)
    assert all(torch.equal(a, b) for a, b in zip(new, old))
    assert torch.equal(m_new, m_old)


def test_layout_takes_the_plain_version_on_the_cpu_only():
    """CPU tensors take the plain version; a tensor on any other device than
    a CUDA one raises before a launch, with no fallback."""
    packed, idx = torch.randn(8, 20), torch.tensor([[3, 1, 7], [0, 2, 2]])
    assert torch.equal(tfu.minibatch_layout(packed, idx), tfu.minibatch_layout_plain(packed, idx))
    with pytest.raises(ValueError):
        tfu.minibatch_layout(packed.to("meta"), idx.to("meta"))


# On the card: F = 20 (the quadrotor), 9 (cart-pole, 36-B rows) and
# 12 + 8 + 4; minibatches of 64 (SafeExplorerPPO), 4,096 and 1,048,576
# (the train cells), and tails shorter than a tile.
CARD_SHAPES = [(20, 64), (20, 4096), (20, 1 << 20), (9, 64), (9, 4096), (9, 1 << 20),
               (24, 64), (24, 4096), (24, 1 << 20), (20, 1000), (9, 1001), (140, 333)]


@pytest.mark.parametrize("F,m", CARD_SHAPES)
def test_kernel_matches_plain_on_card(F, m):
    """The kernel's blocks are ``torch.equal`` to the plain expression's,
    for 4 minibatches of ``m`` drawn from a permutation of 4 m rows, from
    rows 16-B aligned, 8-B aligned and 4-B aligned (a buffer offset by 0, 2
    and 1 floats), for a rank's column slice of the index, and two launches
    agree bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(F * m)
    n_mini, N = 4, 4 * m + 7
    idx = torch.randperm(N, generator=gen, device=dev)[:n_mini * m].reshape(n_mini, m)
    store = torch.randn(N * F + 2, generator=gen, device=dev)
    for off in (0, 2, 1):
        packed = store[off:off + N * F].view(N, F)
        want = tfu.minibatch_layout_plain(packed, idx)
        before = tfu.minibatch_layout.launches
        got = tfu.minibatch_layout(packed, idx)
        again = tfu.minibatch_layout(packed, idx)
        torch.cuda.synchronize()
        assert tfu.minibatch_layout.launches == before + 2
        assert torch.equal(got, want) and torch.equal(again, got), off
    half = idx[:, m // 2:]
    assert torch.equal(tfu.minibatch_layout(packed, half), tfu.minibatch_layout_plain(packed, half))


def test_train_step_bit_equal_on_card():
    """One train step of the quadrotor train cell's size (32,768 envs x 128
    steps, 10 epochs of 4 minibatches of 1,048,576, the configuration of
    ``portbench/configs/quad3d_fig8_ppo.json``) through the kernel leaves the
    parameters, both optimizers' moments and the loss means bit for bit
    where the parent's gather and transpose leave them, with one layout
    launch an epoch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    with open(os.path.join(ROOT, "portbench", "configs", "quad3d_fig8_ppo.json")) as f:
        cfg = json.load(f)
    B, T = 32768, 128
    dev = torch.device("cuda")

    def make():
        env = tq.make_quadrotor(tq.QuadrotorConfig(**cfg["env"]), device=dev)
        return PPO(env, seed=11, use_fast_rollout=True, rollout_batch_size=B, rollout_steps=T,
                   mini_batch_size=B * T // 4, **cfg["ppo"])

    before = tfu.minibatch_layout.launches
    (new, m_new), (old, m_old) = _step_pair(make)
    torch.cuda.synchronize()
    assert tfu.minibatch_layout.launches == before + cfg["ppo"]["opt_epochs"]
    assert all(torch.equal(a, b) for a, b in zip(new, old))
    assert torch.equal(m_new, m_old)
