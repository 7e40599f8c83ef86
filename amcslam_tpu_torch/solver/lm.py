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

The reference's `lax.while_loop`s become host loops over in-place steps of
a static carry (`Carry`): the state, chi, lambda and nu, and the
linearization, updated in place, so that the same tensors are read and
written by every iteration:

  chi0       chi = chi2(state)
  linearize  lin = linearize(state), ini_chi = chi
  lambda0    (first iteration) lambda = lambda_init or tau * max|diag H|, nu = 2
  trial      solve, retract, chi2 and the control law; the accept is a
             torch.where into the carry; the packet (rho, accept, Raul) is
             written for the host

The host reads the packet once per trial and keeps the loop control. The
steps run through a `graphs.Program`: plain calls on the CPU (and in the
public `lm_segment` / `lm_optimize`), replays of CUDA graphs captured once
per problem signature on the card for the solves that ask for it (the pose
solve, MC-RANSAC and the local BA; solver/graphs.py). For a graph the
problem's closures are rebuilt inside every captured step from the static
data (`problem_fn`), so that nothing they derive from the data goes stale.

A problem is the reference's five-closure protocol:
  chi2(state)            -> 0-d tensor, robust total chi2 of active edges
  linearize(state)       -> lin (a tree of tensors)
  max_abs_diag(lin)      -> 0-d tensor (active slots only)
  solve(lin, lam)        -> (dx, dot_xx, dot_xb)
  retract(state, dx)     -> state

`lm_optimize_batched` runs B independent problems of one shape together,
the counterpart of the reference's `jax.vmap` over `lm_optimize`: the same
closures, with a leading member dimension on the state, on every returned
scalar and on lambda.
"""

from __future__ import annotations

import threading
from collections import Counter
from typing import Any, Callable, NamedTuple

import torch

from ..utils.timing import GLOBAL_TIMER
from . import graphs

# Linearizations run, by the kind of solve (eager or replayed): a replayed
# step runs no Python closure, so a run counts them here.
LINEARIZATIONS: Counter = Counter()
_COUNT_LOCK = threading.Lock()


def _read(t: torch.Tensor) -> list:
    """The LM loop's one host read per trial (a device sync on CUDA; the
    copy releases the GIL while it waits, so a second solving thread goes on)."""
    with GLOBAL_TIMER.span("host.read"):
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


class Carry:
    """The static carry of one LM run. `static` keeps the linearization in
    a buffer of its own (a graph reads it at a fixed address); a plain run
    keeps the linearization as it comes."""

    def __init__(self, state, chi, lam, ni, static: bool):
        self.static = static
        self.state = graphs.clone(state)
        self.chi = chi.clone()
        self.lam = lam.clone()
        self.ni = ni.clone()
        self.chi0 = chi.clone()
        self.ini_chi = chi.clone()
        self.packet = chi.new_zeros(3)
        self.lin = None

    @classmethod
    def start(cls, state, static: bool) -> "Carry":
        """A carry for the run from `state` (chi0 still to be run)."""
        dtype, device = graphs.leaves(state)[0].dtype, graphs.leaves(state)[0].device
        zero = torch.zeros((), dtype=dtype, device=device)
        return cls(state, zero, zero, zero + 2.0, static)

    def lm_carry(self, nbad: int = 0, it: int = 0, term: bool = False) -> LMCarry:
        return LMCarry(state=self.state, chi=self.chi, lam=self.lam, ni=self.ni,
                       nbad=nbad, it=it, term=term, chi0=self.chi0)


def _chi0_step(problem: LMProblem, c: Carry) -> None:
    c.chi.copy_(problem.chi2(c.state))
    c.chi0.copy_(c.chi)
    c.lam.zero_()
    c.ni.fill_(2.0)


def _linearize_step(problem: LMProblem, c: Carry) -> None:
    c.lin = graphs.store(c.lin, problem.linearize(c.state), c.static)
    # g2o recomputes chi2 here, but the state is unchanged since the last
    # accepted trial: the carried value is identical.
    c.ini_chi.copy_(c.chi)


def _lambda0_step(problem: LMProblem, c: Carry, lambda_init: float, tau: float) -> None:
    if lambda_init > 0:
        c.lam.fill_(lambda_init)
    else:
        c.lam.copy_(tau * problem.max_abs_diag(c.lin))
    c.ni.fill_(2.0)


def _trial_step(problem: LMProblem, c: Carry) -> None:
    big = torch.finfo(c.chi.dtype).max
    dx, dot_xx, dot_xb = problem.solve(c.lin, c.lam)
    new_state = problem.retract(c.state, dx)
    temp_chi = problem.chi2(new_state)
    temp_chi = torch.where(torch.isfinite(temp_chi), temp_chi, big)
    scale = c.lam * dot_xx + dot_xb + 1e-3
    rho = (c.chi - temp_chi) / scale
    good = (rho > 0) & torch.isfinite(temp_chi) & (temp_chi < big)
    alpha = 1.0 - (2.0 * rho - 1.0) ** 3
    scale_factor = torch.clamp(torch.clamp(alpha, max=2.0 / 3.0), min=1.0 / 3.0)
    chi = torch.where(good, temp_chi, c.chi)
    raul = (c.ini_chi - chi) * 1e3 < c.ini_chi
    c.packet.copy_(torch.stack([rho, good.to(rho.dtype), raul.to(rho.dtype)]))
    for s, n in zip(graphs.leaves(c.state), graphs.leaves(new_state), strict=True):
        s.copy_(torch.where(good, n, s))
    c.lam.copy_(torch.where(good, c.lam * scale_factor, c.lam * c.ni))
    c.ni.copy_(torch.where(good, 2.0, c.ni * 2.0))
    c.chi.copy_(chi)


class Steps:
    """The steps of one LM run over `carry`, through `program` under names
    ending in `tag`. `problem_fn()` builds the closures over the run's
    data: once for a plain program, inside every captured step for a
    graphed one. `kind` names the solve in `LINEARIZATIONS`."""

    def __init__(self, program: graphs.Program, carry, problem_fn: Callable[[], LMProblem],
                 tag: str = "", lambda_init: float = 0.0, tau: float = 1e-5,
                 max_trials: int = 10, kind: str = "lm"):
        self.program, self.carry, self.problem_fn, self.tag = program, carry, problem_fn, tag
        self.lambda_init, self.tau, self.max_trials, self.kind = lambda_init, tau, max_trials, kind
        self._problem = None

    def _run(self, name: str, step, *args) -> None:
        c = self.carry
        if self.program.graphed:
            self.program.run(name + self.tag, lambda: step(self.problem_fn(), c, *args))
            return
        if self._problem is None:
            self._problem = self.problem_fn()
        self.program.run(name + self.tag, lambda: step(self._problem, c, *args))

    def _linearized(self) -> None:
        with _COUNT_LOCK:
            LINEARIZATIONS[self.kind] += 1

    def chi0(self) -> None:
        """Start the run: chi = chi0 = chi2(state), lambda = 0, nu = 2."""
        self._run("chi0", _chi0_step)

    def segment(self, carry: LMCarry, num_iterations: int) -> LMCarry:
        """Advance the run until `it` reaches `num_iterations` (an absolute
        cap) or the g2o termination criteria fire; `carry` gives the host's
        part (nbad, it, term), the tensors are this run's carry."""
        nbad, it, term = carry.nbad, carry.it, carry.term
        while it < num_iterations and not term:
            self._run("linearize", _linearize_step)
            self._linearized()
            if it == 0:
                self._run("lambda0", _lambda0_step, self.lambda_init, self.tau)
                nbad = 0
            qmax = 0
            while True:
                self._run("trial", _trial_step)
                # the one host read of the trial
                rho, _, raul_bad = _read(self.carry.packet)
                qmax += 1
                if not (rho < 0 and qmax < self.max_trials):
                    break
            term = qmax == self.max_trials or rho == 0
            nbad = nbad + 1 if raul_bad else 0
            term = term or nbad >= 3
            it += 1
        return self.carry.lm_carry(nbad, it, term)


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
    absolute cap) or the g2o termination criteria fire. The run works on
    copies of the carry's tensors; the returned carry holds them."""
    c = Carry(carry.state, carry.chi, carry.lam, carry.ni, static=False)
    c.chi0 = carry.chi0
    steps = Steps(graphs.Program(False), c, lambda: problem, lambda_init=lambda_init,
                  tau=tau, max_trials=max_trials)
    return steps.segment(carry, num_iterations)


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


# ---------------------------------------------------------------------------
# the batched driver
# ---------------------------------------------------------------------------


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


class BatchCarry:
    """The static carry of `lm_optimize_batched`: per member the state, chi,
    lambda, nu, the Raul count, the iteration, the termination, whether it
    runs and whether it is in its trial loop, its trial count; the packet
    (any trying, any running) for the host."""

    def __init__(self, state, static: bool):
        t = graphs.leaves(state)[0]
        B, dtype, device = t.shape[0], t.dtype, t.device
        self.static = static
        self.state = graphs.clone(state)
        f = torch.zeros(B, dtype=dtype, device=device)
        i = torch.zeros(B, dtype=torch.int64, device=device)
        b = torch.zeros(B, dtype=torch.bool, device=device)
        self.chi, self.chi0, self.ini_chi, self.lam, self.ni = (f.clone() for _ in range(5))
        self.nbad, self.it, self.qmax = (i.clone() for _ in range(3))
        self.term, self.running, self.trying = (b.clone() for _ in range(3))
        self.packet = torch.zeros(2, dtype=torch.bool, device=device)
        self.lin = None


def _batch_chi0_step(problem: LMProblem, c: BatchCarry) -> None:
    c.chi.copy_(problem.chi2(c.state))
    c.chi0.copy_(c.chi)
    c.lam.zero_()
    c.ni.fill_(2.0)
    c.nbad.zero_()
    c.it.zero_()
    c.term.zero_()
    c.running.fill_(True)


def _batch_linearize_step(problem: LMProblem, c: BatchCarry, lambda_init: float,
                          tau: float) -> None:
    c.lin = graphs.store(c.lin, problem.linearize(c.state), c.static)
    c.ini_chi.copy_(c.chi)
    first = c.running & (c.it == 0)
    lam0 = (torch.full_like(c.lam, lambda_init) if lambda_init > 0
            else tau * problem.max_abs_diag(c.lin))
    c.lam.copy_(torch.where(first, lam0, c.lam))
    c.ni.copy_(torch.where(first, 2.0, c.ni))
    c.nbad.copy_(torch.where(first, 0, c.nbad))
    c.trying.copy_(c.running)
    c.qmax.zero_()


def _batch_trial_step(problem: LMProblem, c: BatchCarry, num_iterations: int,
                      max_trials: int) -> None:
    big = torch.finfo(c.chi.dtype).max
    trying = c.trying
    dx, dot_xx, dot_xb = problem.solve(c.lin, c.lam)
    new_state = problem.retract(c.state, dx)
    temp_chi = problem.chi2(new_state)
    temp_chi = torch.where(torch.isfinite(temp_chi), temp_chi, big)
    scale = c.lam * dot_xx + dot_xb + 1e-3
    rho = (c.chi - temp_chi) / scale
    good = (rho > 0) & torch.isfinite(temp_chi) & (temp_chi < big)
    alpha = 1.0 - (2.0 * rho - 1.0) ** 3
    scale_factor = torch.clamp(torch.clamp(alpha, max=2.0 / 3.0), min=1.0 / 3.0)
    accept = trying & good
    graphs.copy_(c.state, _select(accept, c.state, new_state))
    chi = torch.where(accept, temp_chi, c.chi)
    c.lam.copy_(torch.where(trying, torch.where(good, c.lam * scale_factor, c.lam * c.ni),
                            c.lam))
    c.ni.copy_(torch.where(trying, torch.where(good, 2.0, c.ni * 2.0), c.ni))
    qmax = c.qmax + trying.to(torch.int64)
    again = trying & (rho < 0) & (qmax < max_trials)
    # members whose trial loop ended close their outer iteration
    ended = trying & ~again
    raul_bad = (c.ini_chi - chi) * 1e3 < c.ini_chi
    nbad = torch.where(ended, torch.where(raul_bad, c.nbad + 1, 0), c.nbad)
    stop = (qmax == max_trials) | (rho == 0) | (nbad >= 3)
    term = torch.where(ended, stop, c.term)
    it = c.it + ended.to(torch.int64)
    c.running.copy_(torch.where(ended, ~term & (it < num_iterations), c.running))
    c.chi.copy_(chi)
    c.qmax.copy_(qmax)
    c.nbad.copy_(nbad)
    c.term.copy_(term)
    c.it.copy_(it)
    c.trying.copy_(again)
    c.packet.copy_(torch.stack([again.any(), c.running.any()]))


class BatchSteps(Steps):
    """The steps of one batched LM run over a `BatchCarry` (see `Steps`)."""

    def run(self, num_iterations: int) -> None:
        """The whole run from the carry's state: chi0, then outer
        iterations until no member runs; one host read per trial round."""
        self._run("chi0", _batch_chi0_step)
        any_running = num_iterations > 0
        while any_running:
            self._run("linearize", _batch_linearize_step, self.lambda_init, self.tau)
            self._linearized()
            any_trying = True
            while any_trying:
                self._run("trial", _batch_trial_step, num_iterations, self.max_trials)
                any_trying, any_running = _read(self.carry.packet)


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
    c = BatchCarry(state0, static=False)
    BatchSteps(graphs.Program(False), c, lambda: problem, lambda_init=lambda_init,
               tau=tau, max_trials=max_trials).run(num_iterations)
    return c.state, LMBatchStats(chi2=c.chi, iterations=c.it, lam=c.lam,
                                 initial_chi2=c.chi0)
