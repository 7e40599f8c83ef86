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
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


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
            rho_h, good, raul_bad = torch.stack(
                [rho, good_t.to(dtype), raul_t.to(dtype)]).tolist()
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
