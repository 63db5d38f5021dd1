"""K4: exact PPO actor+critic gradients of one minibatch.

Port of ``safe_control_gym_tpu/parallel/fast_update.py`` (TPU kernel
``_make_kernel_body -> body``, :44-207).  :func:`ppo_grads` launches the
CUDA kernel ``csrc/ppo_update.cu`` for CUDA tensors and takes the plain
PyTorch version :func:`ppo_grads_plain` for CPU tensors; anything else
raises.  Both compute the dual-MLP forward, the clipped-surrogate and
value-MSE losses, and the same hand-written backward, with the subgradient
conventions of ``fast_update.py:151-158``: ``jnp.minimum`` passes to the
smaller branch (half each at an exact tie) and the clip passes iff the
ratio is strictly inside the bounds.  At a ratio exactly on a clip bound
``jax.grad`` of ``jnp.clip`` (a maximum and a minimum, which split ties)
passes half instead; the kernel convention is kept.

K4 returns gradients; it is not a ``torch.autograd.Function``, as the JAX
kernel runs outside any ``custom_vjp``.  The controller's other update path
(``controllers/ppo.py``, ``use_fast_update=False``) uses ``torch.autograd``.

Scope (:func:`kernel_scope`, the JAX package's ``use_fast_update="auto"``
rule, ``safe_control_gym_tpu/controllers/ppo.py:240-256``):
``use_clipped_value=False``, tanh
or relu MLPs of two hidden layers of one width H <= 256, obs_dim <= 128,
act_dim <= 8, a Gaussian policy with state-independent logstd.  The TPU's
4096-sample chunks and its multiple-of-1024 guard are VMEM and Mosaic
limits: the kernel takes any minibatch of a multiple of 8.  The JAX kernel
takes any H; this one stops at 256, where one net's gradient tiles need up
to five passes over the forward.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)

# Flat weight/gradient layout, kernel orientation W (out, in): the segments
# of csrc/ppo_update.cu, then the 3 loss sums of the gradient vector.
SEGMENTS = ("w1a", "b1a", "w2a", "b2a", "w3a", "b3a",
            "w1c", "b1c", "w2c", "b2c", "w3c", "b3c", "logstd")


def segment_shapes(nx: int, nu: int, H: int) -> dict:
    return {"w1a": (H, nx), "b1a": (H,), "w2a": (H, H), "b2a": (H,), "w3a": (nu, H), "b3a": (nu,),
            "w1c": (H, nx), "b1c": (H,), "w2c": (H, H), "b2c": (H,), "w3c": (1, H), "b3c": (1,),
            "logstd": (nu,)}


def prep_weights(actor, critic, logstd) -> dict:
    """Port ``MLP`` modules + logstd -> the kernel's weight tensors (detached,
    W (out, in) as ``nn.Linear`` stores it).  flax's ``Dense.kernel`` is
    (in, out), so the JAX wrapper passes both orientations
    (fast_update.py:266-280); K4 reads only W (out, in)."""
    w = {}
    for net, tag in ((actor, "a"), (critic, "c")):
        for i, layer in enumerate(net.layers):
            w[f"w{i + 1}{tag}"] = layer.weight.detach()
            w[f"b{i + 1}{tag}"] = layer.bias.detach()
    w["logstd"] = logstd.detach()
    return w


def _act(name):
    if name == "tanh":
        return torch.tanh, lambda a, z: 1.0 - a * a
    if name == "relu":
        return (lambda z: torch.maximum(z, torch.zeros_like(z)),
                lambda a, z: (z > 0.0).to(z.dtype))
    raise ValueError(f"K4 supports tanh and relu, not {name!r}")


def ppo_grads_plain(mb, w, *, clip: float, act: str = "tanh"):
    """Plain PyTorch version of K4 (fast_update.py:128-190).

    ``mb``: (nx+nu+4, n) packed minibatch, batch last; ``w``: dict of
    :data:`SEGMENTS` tensors.  Returns ``(grads, loss_sums)``: a dict keyed
    like ``w`` (gradients) and (3,) = [sum min_surr, sum (logp_old - logp),
    sum (v - ret)^2]."""
    f, fp = _act(act)
    nu, nx = w["w3a"].shape[0], w["w1a"].shape[1]
    n = mb.shape[1]
    inv_n = 1.0 / n
    X, A = mb[:nx], mb[nx:nx + nu]
    logp_old, ret, adv = mb[nx + nu + 1], mb[nx + nu + 2], mb[nx + nu + 3]
    col = lambda b: b[:, None]  # noqa: E731

    z1a = w["w1a"] @ X + col(w["b1a"])
    a1 = f(z1a)
    z2a = w["w2a"] @ a1 + col(w["b2a"])
    a2 = f(z2a)
    mean = w["w3a"] @ a2 + col(w["b3a"])
    z1c = w["w1c"] @ X + col(w["b1c"])
    c1 = f(z1c)
    z2c = w["w2c"] @ c1 + col(w["b2c"])
    c2 = f(z2c)
    v = (w["w3c"] @ c2 + col(w["b3c"]))[0]

    logstd = col(w["logstd"])
    inv_var = torch.exp(-2.0 * logstd)
    diff = A - mean
    logp = (-0.5 * diff * diff * inv_var - logstd - _HALF_LOG_2PI).sum(0)
    ratio = torch.exp(logp - logp_old)
    surr1 = ratio * adv
    surr2 = torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv
    min_surr = torch.minimum(surr1, surr2)
    take1 = (surr1 < surr2).to(mb.dtype) + 0.5 * (surr1 == surr2).to(mb.dtype)
    inside = ((ratio > 1.0 - clip) & (ratio < 1.0 + clip)).to(mb.dtype)
    w_pol = -inv_n * (take1 + (1.0 - take1) * inside) * ratio * adv

    g = {}
    gmean = w_pol * (diff * inv_var)
    g["w3a"], g["b3a"] = gmean @ a2.T, gmean.sum(1)
    ga2 = (w["w3a"].T @ gmean) * fp(a2, z2a)
    g["w2a"], g["b2a"] = ga2 @ a1.T, ga2.sum(1)
    ga1 = (w["w2a"].T @ ga2) * fp(a1, z1a)
    g["w1a"], g["b1a"] = ga1 @ X.T, ga1.sum(1)
    g["logstd"] = (w_pol * (diff * diff * inv_var - 1.0)).sum(1)

    verr = v - ret
    gv = (inv_n * verr)[None]
    g["w3c"], g["b3c"] = gv @ c2.T, gv.sum(1)
    gc2 = (w["w3c"].T @ gv) * fp(c2, z2c)
    g["w2c"], g["b2c"] = gc2 @ c1.T, gc2.sum(1)
    gc1 = (w["w2c"].T @ gc2) * fp(c1, z1c)
    g["w1c"], g["b1c"] = gc1 @ X.T, gc1.sum(1)
    sums = torch.stack([min_surr.sum(), (logp_old - logp).sum(), (verr * verr).sum()])
    return g, sums


MAX_OBS, MAX_ACT, MAX_HIDDEN = 128, 8, 256


def kernel_scope(nx: int, nu: int, H: int, act: str, mb: int, clipped_value: bool) -> bool:
    """Whether K4 takes this update: the JAX ``auto`` rule (``ppo.py:240-256``)
    without its TPU-only chunk terms (``mb % 1024`` / ``% 4096``, VMEM and
    Mosaic limits), and with the port's width limit ``H <= 256``."""
    return (not clipped_value and act in ("tanh", "relu")
            and 1 <= nx <= MAX_OBS and 1 <= nu <= MAX_ACT and 1 <= H <= MAX_HIDDEN
            and mb > 0 and mb % 8 == 0)


def _f32(v) -> float:
    return float(np.float32(v))


_PLAN_LEN = 8  # csrc/ppo_update.cu::ppo_grads_plan
_plans: dict = {}


def _plan(lib, nx: int, nu: int, H: int, n: int, device):
    """The kernel's launch plan for one shape on one device, worked out (and
    its shared-memory attribute set) once: (ng, nsb, slices, ts, r, smem_w,
    smem_bytes, wpad_floats) as a ctypes int array."""
    from safe_control_gym_torch import kernels

    key = (nx, nu, H, n, device.index)
    plan = _plans.get(key)
    if plan is None:
        plan = (ctypes.c_int * _PLAN_LEN)()
        with torch.cuda.device(device):
            code = lib.ppo_grads_plan(nx, nu, H, n, plan)
        if code == -1:
            raise ValueError(f"ppo_grads: nx={nx}, nu={nu}, H={H}, mb={n} is outside the "
                             "kernel's scope")
        kernels.check(code, "ppo_grads_plan")
        _plans[key] = plan
    return plan


def ppo_grads(mb, w, *, clip: float, act: str = "tanh"):
    """K4: the gradients and loss sums of :func:`ppo_grads_plain`.

    CPU tensors take the plain version; CUDA float32 tensors launch
    ``csrc/ppo_update.cu``; anything else raises."""
    tensors = [mb, *(w[k] for k in SEGMENTS)]
    if all(t.device.type == "cpu" for t in tensors):
        return ppo_grads_plain(mb, w, clip=clip, act=act)
    nu, nx, H = w["w3a"].shape[0], w["w1a"].shape[1], w["w1a"].shape[0]
    n = mb.shape[1] if mb.dim() == 2 else -1
    shapes = segment_shapes(nx, nu, H)
    ok = (mb.dim() == 2 and mb.shape[0] == nx + nu + 4 and n > 0 and n % 8 == 0
          and all(tuple(w[k].shape) == shapes[k] for k in SEGMENTS)
          and all(t.device == mb.device and t.device.type == "cuda" and t.dtype == torch.float32
                  for t in tensors))
    if not ok or not kernel_scope(nx, nu, H, act, n, False):
        raise ValueError(
            "ppo_grads takes a float32 (nx+nu+4, n) minibatch with n a positive multiple of 8 "
            f"and the {SEGMENTS} weights on one CUDA device, nx <= {MAX_OBS}, nu <= {MAX_ACT}, "
            f"H <= {MAX_HIDDEN}, tanh or relu; got mb {tuple(mb.shape)} {mb.dtype} {mb.device}, "
            f"H {H}, act {act!r}")
    from safe_control_gym_torch import kernels

    lib = kernels.lib()
    plan = _plan(lib, nx, nu, H, n, mb.device)
    mb = mb.contiguous()
    if mb.data_ptr() % 16:  # the kernel reads the minibatch as float4
        mb = mb.clone()
    wflat = torch.cat([w[k].reshape(-1) for k in SEGMENTS])
    f32 = dict(dtype=torch.float32, device=mb.device)
    wpad = torch.empty(plan[7], **f32)
    partial = torch.empty(plan[1] * plan[0], **f32)
    out = torch.empty(plan[0], **f32)
    code = lib.ppo_grads(plan, nx, nu, H, n, int(act == "relu"), _f32(1.0 - clip), _f32(1.0 + clip),
                         _f32(1.0 / n), mb.data_ptr(), wflat.data_ptr(), wpad.data_ptr(),
                         partial.data_ptr(), out.data_ptr(), kernels.stream_ptr(mb.device))
    kernels.check(code, "ppo_grads")
    ppo_grads.launches += 1
    g, o = {}, 0
    for k in SEGMENTS:
        size = math.prod(shapes[k])
        g[k] = out[o:o + size].view(shapes[k])
        o += size
    return g, out[o:o + 3]


ppo_grads.launches = 0


class FastPPOUpdate:
    """Host wrapper: per-minibatch exact PPO gradients (K4)."""

    def __init__(self, mb_size: int, hidden: int, act: str, clip_param: float,
                 obs_dim: int = 12, act_dim: int = 4, clipped_value: bool = False):
        if not kernel_scope(obs_dim, act_dim, hidden, act, mb_size, clipped_value):
            raise ValueError(
                f"K4 takes obs_dim <= {MAX_OBS}, act_dim <= {MAX_ACT}, hidden <= {MAX_HIDDEN}, "
                "tanh or relu, use_clipped_value=False and a minibatch size that is a positive "
                f"multiple of 8; got obs_dim {obs_dim}, act_dim {act_dim}, hidden {hidden}, "
                f"{act!r}, clipped value {clipped_value}, minibatch {mb_size}")
        self.mb = mb_size
        self.H = hidden
        self.act = act
        self.clip = clip_param
        self.nx, self.nu = obs_dim, act_dim
        self.F = obs_dim + act_dim + 4

    prep_weights = staticmethod(prep_weights)

    def grads(self, mb, w):
        """mb: (F, mb) packed minibatch, batch last.

        Returns (actor grads, critic grads, glogstd (nu,), loss_sums (3,));
        the grad dicts are keyed like the modules' ``named_parameters()``."""
        g, sums = ppo_grads(mb, w, clip=self.clip, act=self.act)
        ga = {f"layers.{i}.{p}": g[f"{'w' if p == 'weight' else 'b'}{i + 1}a"]
              for i in range(3) for p in ("weight", "bias")}
        gc = {f"layers.{i}.{p}": g[f"{'w' if p == 'weight' else 'b'}{i + 1}c"]
              for i in range(3) for p in ("weight", "bias")}
        return ga, gc, g["logstd"], sums
