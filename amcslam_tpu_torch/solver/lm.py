"""Levenberg-Marquardt loop with the g2o-exact control law, in PyTorch.

Port of `amcslam_tpu/solver/lm.py` (OptimizationAlgorithmLevenberg::solve):

  * one linearization per outer iteration
  * lambda_0 = user value if > 0 else tau * max|diag H|, tau = 1e-5
  * trial loop (<= max_trials = 10): solve (H + lambda I) dx = b, retract,
    rho = (chi - chi') / (dx . (lambda dx + b) + 1e-3)
    - accept (rho > 0, finite): lambda *= max(1/3, min(2/3, 1-(2 rho-1)^3)),
      nu = 2
    - reject: lambda *= nu, nu *= 2, keep the linearization point
  * terminate when the trial loop exhausts (qmax == max_trials) or rho == 0
  * "Raul" stop: 3 consecutive outer iterations with relative chi2
    improvement < 1e-3

The reference's `lax.while_loop`s become Python loops. Scalars that feed
the arithmetic (chi, lambda, nu, rho) stay 0-d tensors of the problem's dtype
on its device, so the arithmetic is the reference's; the loop control reads
rho, the trial chi2 and the accept flag to the host once per trial.

A problem is the reference's five-closure protocol:
  chi2(state)            -> 0-d tensor, robust total chi2 of active edges
  linearize(state)       -> lin (opaque)
  max_abs_diag(lin)      -> 0-d tensor (active slots only)
  solve(lin, lam)        -> (dx, dot_xx, dot_xb)
  retract(state, dx)     -> state

`lm_optimize_batched` runs B independent problems of one shape together,
the counterpart of the reference's `jax.vmap` over `lm_optimize`: the same
closures, with a leading member dimension on the state, on every returned
scalar and on lambda.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


def _read(t: torch.Tensor) -> list:
    """The LM loop's one host read per trial (a device sync on CUDA)."""
    return t.tolist()


class LMProblem(NamedTuple):
    chi2: Callable[[Any], torch.Tensor]
    linearize: Callable[[Any], Any]
    max_abs_diag: Callable[[Any], torch.Tensor]
    solve: Callable[[Any, torch.Tensor], tuple[Any, torch.Tensor, torch.Tensor]]
    retract: Callable[[Any, Any], Any]


class LMStats(NamedTuple):
    chi2: torch.Tensor        # final robust chi2
    iterations: int           # outer iterations executed
    lam: torch.Tensor         # final lambda
    initial_chi2: torch.Tensor


class LMCarry(NamedTuple):
    """Full LM loop state, checkpointable between outer iterations: running
    a schedule through several `lm_segment` calls (e.g. 4+3+3) repeats the
    op sequence of one `lm_optimize` call exactly."""

    state: Any
    chi: torch.Tensor
    lam: torch.Tensor
    ni: torch.Tensor
    nbad: int
    it: int
    term: bool
    chi0: torch.Tensor


def lm_init(problem: LMProblem, state0: Any) -> LMCarry:
    """Start an LM run: evaluate chi2 once and build the zero-iteration carry."""
    chi0 = problem.chi2(state0)
    zero = torch.zeros((), dtype=chi0.dtype, device=chi0.device)
    return LMCarry(state=state0, chi=chi0, lam=zero, ni=zero + 2.0, nbad=0,
                   it=0, term=False, chi0=chi0)


def lm_segment(
    problem: LMProblem,
    carry: LMCarry,
    num_iterations: int,
    lambda_init: float = 0.0,
    tau: float = 1e-5,
    max_trials: int = 10,
) -> LMCarry:
    """Advance the LM loop until `carry.it` reaches `num_iterations` (an
    absolute cap) or the g2o termination criteria fire."""
    chi = carry.chi
    dtype, device = chi.dtype, chi.device

    def scalar(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    big = scalar(torch.finfo(dtype).max)
    state, lam, ni, nbad, it, term = (
        carry.state, carry.lam, carry.ni, carry.nbad, carry.it, carry.term)

    while it < num_iterations and not term:
        # g2o recomputes chi2 here, but the state is unchanged since the
        # last accepted trial: the carried value is identical.
        ini_chi = chi
        lin = problem.linearize(state)
        if it == 0:
            lam = (scalar(lambda_init) if lambda_init > 0
                   else scalar(tau) * problem.max_abs_diag(lin))
            ni = scalar(2.0)
            nbad = 0

        qmax = 0
        rho_h = 0.0
        while True:
            dx, dot_xx, dot_xb = problem.solve(lin, lam)
            new_state = problem.retract(state, dx)
            temp_chi = problem.chi2(new_state)
            temp_chi = torch.where(torch.isfinite(temp_chi), temp_chi, big)
            scale = lam * dot_xx + dot_xb + scalar(1e-3)
            rho = (chi - temp_chi) / scale
            good_t = (rho > 0) & torch.isfinite(temp_chi) & (temp_chi < big)
            alpha = 1.0 - (2.0 * rho - 1.0) ** 3
            scale_factor = torch.clamp(torch.clamp(alpha, max=2.0 / 3.0), min=1.0 / 3.0)
            lam_new = torch.where(good_t, lam * scale_factor, lam * ni)
            ni = torch.where(good_t, scalar(2.0), ni * 2.0)
            lam = lam_new
            chi_t = torch.where(good_t, temp_chi, chi)
            raul_t = (ini_chi - chi_t) * 1e3 < ini_chi
            # the one host read of the trial
            rho_h, good, raul_bad = _read(torch.stack(
                [rho, good_t.to(dtype), raul_t.to(dtype)]))
            good = bool(good)
            if good:
                state, chi = new_state, temp_chi
            qmax += 1
            if not (rho_h < 0 and qmax < max_trials):
                break

        term = qmax == max_trials or rho_h == 0
        nbad = nbad + 1 if raul_bad else 0
        term = term or nbad >= 3
        it += 1

    return LMCarry(state=state, chi=chi, lam=lam, ni=ni, nbad=nbad, it=it,
                   term=term, chi0=carry.chi0)


def lm_optimize(
    problem: LMProblem,
    state0: Any,
    num_iterations: int,
    lambda_init: float = 0.0,
    tau: float = 1e-5,
    max_trials: int = 10,
):
    """Run up to `num_iterations` LM outer iterations; returns (state, LMStats).
    One-segment wrapper over lm_init/lm_segment."""
    c = lm_segment(problem, lm_init(problem, state0), num_iterations,
                   lambda_init=lambda_init, tau=tau, max_trials=max_trials)
    return c.state, LMStats(chi2=c.chi, iterations=c.it, lam=c.lam,
                            initial_chi2=c.chi0)


class LMBatchStats(NamedTuple):
    chi2: torch.Tensor          # (B,) final robust chi2
    iterations: torch.Tensor    # (B,) int64 outer iterations executed
    lam: torch.Tensor           # (B,) final lambda
    initial_chi2: torch.Tensor  # (B,)


def _select(mask: torch.Tensor, a, b):
    """Per member: b where mask else a, over a tensor or a tuple of tensors
    with the member dimension first."""
    if isinstance(a, torch.Tensor):
        return torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - 1)), b, a)
    return type(a)(*(_select(mask, x, y) for x, y in zip(a, b)))


def lm_optimize_batched(
    problem: LMProblem,
    state0: Any,
    num_iterations: int,
    lambda_init: float = 0.0,
    tau: float = 1e-5,
    max_trials: int = 10,
):
    """`lm_optimize` for B members at once; returns (state, LMBatchStats).

    The closures work on the whole batch: chi2 and max_abs_diag return (B,),
    solve takes lam (B,) and returns (B,) dot products. Every member follows
    its own control law, as `jax.vmap` of the reference's while loops does:
    its own lambda_0 from its own max|diag H|, its own trial loop (ended by
    rho > 0 or max_trials), its own Raul counter and termination. A member
    that has stopped keeps its carry while the others go on; its results
    are those of its own `lm_optimize` run (to the last bits of vectorized
    transcendental functions). The loop control costs one host read per
    trial round for the whole batch.
    """
    chi = problem.chi2(state0)
    dtype, device = chi.dtype, chi.device
    B = chi.shape[0]

    def full(x):
        return torch.full((B,), x, dtype=dtype, device=device)

    big = torch.finfo(dtype).max
    zero_i = torch.zeros(B, dtype=torch.int64, device=device)
    state, chi0 = state0, chi
    lam, ni, nbad, it = full(0.0), full(2.0), zero_i, zero_i
    term = torch.zeros(B, dtype=torch.bool, device=device)
    running = ~term
    any_running = num_iterations > 0

    while any_running:
        ini_chi = chi
        lin = problem.linearize(state)
        first = running & (it == 0)
        lam0 = (full(lambda_init) if lambda_init > 0
                else tau * problem.max_abs_diag(lin))
        lam = torch.where(first, lam0, lam)
        ni = torch.where(first, full(2.0), ni)
        nbad = torch.where(first, zero_i, nbad)

        trying = running
        qmax = zero_i
        any_trying = True
        while any_trying:
            dx, dot_xx, dot_xb = problem.solve(lin, lam)
            new_state = problem.retract(state, dx)
            temp_chi = problem.chi2(new_state)
            temp_chi = torch.where(torch.isfinite(temp_chi), temp_chi, full(big))
            scale = lam * dot_xx + dot_xb + 1e-3
            rho = (chi - temp_chi) / scale
            good = (rho > 0) & torch.isfinite(temp_chi) & (temp_chi < big)
            alpha = 1.0 - (2.0 * rho - 1.0) ** 3
            scale_factor = torch.clamp(torch.clamp(alpha, max=2.0 / 3.0), min=1.0 / 3.0)
            accept = trying & good
            state = _select(accept, state, new_state)
            chi = torch.where(accept, temp_chi, chi)
            lam = torch.where(trying, torch.where(good, lam * scale_factor, lam * ni), lam)
            ni = torch.where(trying, torch.where(good, full(2.0), ni * 2.0), ni)
            qmax = qmax + trying.to(torch.int64)
            again = trying & (rho < 0) & (qmax < max_trials)
            # members whose trial loop ended close their outer iteration
            ended = trying & ~again
            raul_bad = (ini_chi - chi) * 1e3 < ini_chi
            nbad = torch.where(ended, torch.where(raul_bad, nbad + 1, zero_i), nbad)
            stop = (qmax == max_trials) | (rho == 0) | (nbad >= 3)
            term = torch.where(ended, stop, term)
            it = it + ended.to(torch.int64)
            running = torch.where(ended, ~term & (it < num_iterations), running)
            trying = again
            any_trying, any_running = _read(torch.stack([trying.any(), running.any()]))

    return state, LMBatchStats(chi2=chi, iterations=it, lam=lam, initial_chi2=chi0)
