"""Batched constraint evaluation.

Port of ``safe_control_gym_tpu/envs/constraints.py``: every form of the JAX
package (``default_constraint``, ``bounded_constraint``,
``linear_constraint``, ``quadratic_constraint``, ``symmetric_constraint``) on
the ``state``, ``input`` or ``input_and_state`` variable.  The spec list
compiles once into stacked matrices: the affine rows (default, bounded,
linear) into one map over (state, input), the quadratic rows ``x^T P x -
b`` and the symmetric blocks ``|F x| - b`` beside it, interleaved back into
spec order by ``row_order``.  Semantics kept from the reference: every row
is g(x) <= 0, values are rounded to 8 decimals before the violation test,
``strict`` rows violate at >= 0 and others at > 0, and rows follow the spec
order.  The whole-rollout engines count violations by per-dimension bound
tests and take pure box programs only (:func:`box_bounds_view`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from safe_control_gym_torch.envs.benchmark import EnvSpaces

BIG = 1e30  # Stand-in for the reference's float32 max bounds.


@dataclasses.dataclass(frozen=True)
class CompiledConstraints:
    """Stacked constraint program: the affine rows ``x A_x^T + u A_u^T - b``,
    then the quadratic rows (``quadratics``: (P, b, on_input), P the filtered
    full-dim matrix), then the symmetric blocks (``symmetrics``: (F, b)),
    put in spec order by ``row_order``."""

    num_constraints: int
    A_x: torch.Tensor  # (nc_lin, nx)
    A_u: torch.Tensor  # (nc_lin, nu)
    b: torch.Tensor  # (nc_lin,)
    strict: torch.Tensor  # (nc,) bool
    tolerance: torch.Tensor  # (nc,) float; -inf disables almost-active
    state_only_rows: np.ndarray  # (nc,) bool: rows of state constraints
    quadratics: tuple = ()  # (P (d, d) tensor, b float, on_input bool)
    symmetrics: tuple = ()  # (F (d, nx) tensor, b (d,) tensor)
    row_order: Optional[torch.Tensor] = None  # (nc,) output row -> stacked position
    input_rows: Optional[np.ndarray] = None  # (nc,) bool: rows of input constraints
    rounding: int = 8
    # The state rows' index per device, made once: an index made from host
    # data each call is a host-to-device copy, which synchronizes the host
    # with the card (every auto-reset computes the reset info).
    _state_idx: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def get_values_raw(self, x, u):
        """Unrounded values, differentiable (constraints.py:76-90): x (B,
        nx), u (B, nu) -> (B, nc)."""
        vals = [x @ self.A_x.T + u @ self.A_u.T - self.b]
        for P, b, on_input in self.quadratics:
            v = u if on_input else x
            vals.append(((v @ P) * v).sum(-1, keepdim=True) - b)
        for F, b in self.symmetrics:
            vals.append((x @ F.T).abs() - b)
        stacked = torch.cat(vals, -1) if len(vals) > 1 else vals[0]
        return stacked if self.row_order is None else stacked[..., self.row_order]

    def get_values(self, x, u):
        """x: (B, nx), u: (B, nu) -> (B, nc), rounded to 8 decimals."""
        scale = 10.0 ** self.rounding
        return torch.round(self.get_values_raw(x, u) * scale) / scale

    def is_violated(self, values):
        """Any row violated -> (B,) bool."""
        hit = torch.where(self.strict, values >= 0.0, values > 0.0)
        return hit.any(-1)

    def is_almost_active(self, values):
        """Any row within tolerance of violation -> (B,) bool."""
        return (values + self.tolerance > 0.0).any(-1)

    def get_state_values(self, x):
        """State-constraint rows only (reset info)."""
        u = torch.zeros(x.shape[:-1] + (self.A_u.shape[1],), dtype=x.dtype, device=x.device)
        idx = self._state_idx.get(x.device)
        if idx is None:
            idx = self._state_idx[x.device] = torch.as_tensor(
                np.nonzero(self.state_only_rows)[0], device=x.device)
        return self.get_values(x, u)[..., idx]


def _filter_matrix(dim: int, active_dims) -> np.ndarray:
    if active_dims is None:
        return np.eye(dim)
    if isinstance(active_dims, int):
        active_dims = [active_dims]
    return np.eye(dim)[np.asarray(active_dims)]


def build_constraints(
    specs: Optional[Sequence[dict]], spaces: EnvSpaces, device, dtype=torch.float32
) -> Optional[CompiledConstraints]:
    """Compile YAML constraint specs (reference create_constraint_list,
    constraints.py:594-612; JAX build_constraints, constraints.py:129-283)."""
    if not specs:
        return None
    nx, nu = spaces.state_dim, spaces.action_dim
    lin_Ax, lin_Au, lin_b, quads, syms = [], [], [], [], []
    blocks = []  # (kind, rows, strict, tolerance, var) in spec order
    for spec in specs:
        spec = dict(spec)
        form = spec.pop("constraint_form")
        var = spec.pop("constrained_variable")
        strict = bool(spec.pop("strict", False))
        active_dims = spec.pop("active_dims", None)
        tolerance = spec.pop("tolerance", None)
        dims = {"state": nx, "input": nu, "input_and_state": nx + nu}
        if var not in dims:
            raise ValueError(f"invalid constrained_variable {var!r}")
        F = _filter_matrix(dims[var], active_dims)

        def split(A_full):
            """Full-dim rows -> (state block, input block)."""
            rows = A_full.shape[0]
            if var == "state":
                return A_full, np.zeros((rows, nu))
            if var == "input":
                return np.zeros((rows, nx)), A_full
            return A_full[:, :nx], A_full[:, nx:]

        if form in ("linear_constraint", "bounded_constraint", "default_constraint"):
            if form == "linear_constraint":
                A = np.array(spec["A"], ndmin=2, dtype=float)
                b = np.array(spec["b"], ndmin=1, dtype=float)
            else:
                if form == "default_constraint":
                    # Bounds default to the env spaces (constraints.py:307-368),
                    # clamped to a finite BIG so the affine evaluation stays
                    # NaN-free.
                    if var == "state":
                        lo_def, hi_def = spaces.state_low, spaces.state_high
                    elif var == "input":
                        lo_def, hi_def = spaces.action_low, spaces.action_high
                    else:
                        raise ValueError("default_constraint must be state or input")
                    lo = np.maximum(np.asarray(spec.get("lower_bounds", lo_def), float), -BIG)
                    hi = np.minimum(np.asarray(spec.get("upper_bounds", hi_def), float), BIG)
                else:
                    lo = np.array(spec["lower_bounds"], ndmin=1, dtype=float)
                    hi = np.array(spec["upper_bounds"], ndmin=1, dtype=float)
                d = lo.shape[0]
                A, b = np.vstack([-np.eye(d), np.eye(d)]), np.hstack([-lo, hi])
            Ax, Au = split(A @ F)
            lin_Ax.append(Ax)
            lin_Au.append(Au)
            lin_b.append(b)
            blocks.append(("lin", A.shape[0], strict, tolerance, var))
        elif form == "symmetric_constraint":
            # |x_filtered| <= bound, one row a bound (constraints.py:209-222).
            if var != "state":
                raise ValueError("symmetric_constraint must be on state")
            bound = np.array(spec["bound"], ndmin=1, dtype=float)
            if F.shape[0] != bound.shape[0] and active_dims is None and bound.shape[0] < nx:
                raise ValueError("symmetric_constraint bound dim does not match state dim")
            syms.append((F, bound))
            blocks.append(("sym", bound.shape[0], strict, tolerance, var))
        elif form == "quadratic_constraint":
            P = np.array(spec["P"], ndmin=2, dtype=float)
            quads.append((F.T @ P @ F, float(spec["b"]), var == "input"))
            blocks.append(("quad", 1, strict, tolerance, var))
        else:
            raise ValueError(f"unknown constraint_form {form!r}")

    # Output rows in spec order over the stacked [affine, quadratic,
    # symmetric] values (constraints.py:239-269).
    cursor = {"lin": 0, "quad": sum(n for k, n, *_ in blocks if k == "lin")}
    cursor["sym"] = cursor["quad"] + len(quads)
    row_order, strict_v, tol_v, state_v, input_v = [], [], [], [], []
    for kind, n, strict, tol, var in blocks:
        row_order += range(cursor[kind], cursor[kind] + n)
        cursor[kind] += n
        strict_v += [strict] * n
        if tol is None:
            tol_v += [-np.inf] * n
        else:
            t = np.array(tol, ndmin=1, dtype=float)
            tol_v += (t if t.size == n else np.full(n, t[0])).tolist()
        state_v += [var == "state"] * n
        input_v += [var == "input"] * n

    def dev(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    ordered = row_order == list(range(len(row_order)))
    return CompiledConstraints(
        num_constraints=len(row_order),
        A_x=dev(np.vstack(lin_Ax) if lin_Ax else np.zeros((0, nx))),
        A_u=dev(np.vstack(lin_Au) if lin_Au else np.zeros((0, nu))),
        b=dev(np.hstack(lin_b) if lin_b else np.zeros((0,))),
        strict=dev(strict_v, torch.bool),
        tolerance=dev(tol_v),
        state_only_rows=np.asarray(state_v, bool),
        quadratics=tuple((dev(P), b, on_input) for P, b, on_input in quads),
        symmetrics=tuple((dev(F), dev(b)) for F, b in syms),
        row_order=None if ordered else dev(row_order, torch.long),
        input_rows=np.asarray(input_v, bool),
    )


def box_bounds_view(specs, nx: int, nu: int, spaces=None):
    """Per-dim box bounds when ``specs`` is a pure box program, else None.

    The whole-rollout kernel counts violations with per-dimension bound
    tests, which is exact only when every spec is a non-strict default or
    bounded box on ``state`` or ``input``.  Returns ``(s_lo, s_hi, u_lo,
    u_hi)`` with bounds intersected across specs and ``±BIG`` where
    unconstrained; with ``spaces=None`` default-constraint bounds degrade to
    ``±BIG`` placeholders (enough for a validity check)."""
    if not specs:
        return None
    s_lo, s_hi = np.full(nx, -BIG), np.full(nx, BIG)
    u_lo, u_hi = np.full(nu, -BIG), np.full(nu, BIG)
    for spec in specs:
        form = spec.get("constraint_form")
        var = spec.get("constrained_variable")
        if form not in ("bounded_constraint", "default_constraint"):
            return None
        if var not in ("state", "input"):
            return None
        if spec.get("strict", False):
            return None
        dim = nx if var == "state" else nu
        ad = spec.get("active_dims")
        dims = np.arange(dim) if ad is None else np.atleast_1d(np.asarray(ad, int))
        if dims.ndim != 1 or (dims < 0).any() or (dims >= dim).any():
            return None
        if form == "default_constraint":
            if spaces is not None:
                lo_def = np.asarray(
                    spaces.state_low if var == "state" else spaces.action_low, float)
                hi_def = np.asarray(
                    spaces.state_high if var == "state" else spaces.action_high, float)
            else:
                lo_def, hi_def = np.full(dim, -BIG), np.full(dim, BIG)
            lo = np.asarray(spec.get("lower_bounds", lo_def[dims]), float).ravel()
            hi = np.asarray(spec.get("upper_bounds", hi_def[dims]), float).ravel()
        else:
            if "lower_bounds" not in spec or "upper_bounds" not in spec:
                return None
            lo = np.asarray(spec["lower_bounds"], float).ravel()
            hi = np.asarray(spec["upper_bounds"], float).ravel()
        if lo.size != dims.size or hi.size != dims.size:
            return None
        tgt_lo, tgt_hi = (s_lo, s_hi) if var == "state" else (u_lo, u_hi)
        np.maximum.at(tgt_lo, dims, np.maximum(lo, -BIG))
        np.minimum.at(tgt_hi, dims, np.minimum(hi, BIG))
    return s_lo, s_hi, u_lo, u_hi
