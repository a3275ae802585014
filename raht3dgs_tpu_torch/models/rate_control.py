"""Sequence-global rate allocation: leaky-bucket CBR over frame budgets.

Counterpart of ``raht3dgs_tpu/models/rate_control.py``, plain Python
carried as it is. The per-frame search (``models/rd_search.py``) is
one-sided: every frame lands at or under its budget, so a sequence encoded
at ``--target-bpp T`` underspends by what the discrete step grid leaves
(~5-15% a frame). :class:`RateController` carries the unspent bits forward
as *credit*: frame k may spend ``T + credit_k``, where credit is the
accumulated (and capped) underspend of frames 0..k-1.

Because credit only ever holds bits that earlier frames left unspent
(never a loan against future frames), the cumulative spend obeys

    sum(actual[0..k]) <= (k+1) * T        for EVERY prefix k,

the guarantee a fixed-bandwidth channel needs. Per-frame spend is bounded
by ``T + burst`` (the bucket depth), so a decoder buffer of ``burst``
bpp-equivalents never underflows.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field


@dataclass
class RateController:
    """Leaky-bucket credit carry for one-sided per-frame rate searches.

    Usage::

        rc = RateController(target_bpp=2.0)
        for frame in frames:
            r = search_step_for_bpp(frame, rc.frame_budget(), ...)
            rc.update(r.bpp)

    ``burst`` is the bucket depth in bpp: the maximum credit carried
    (default = one full frame's budget). ``burst=0`` degenerates to
    independent per-frame budgets.
    """

    target_bpp: float
    burst: float = None  # type: ignore[assignment]  # default set below
    credit: float = field(default=0.0, init=False)
    frames: int = field(default=0, init=False)
    spent: float = field(default=0.0, init=False)

    def __post_init__(self) -> None:
        if not self.target_bpp > 0:
            raise ValueError(
                f"target_bpp must be positive, got {self.target_bpp}"
            )
        if self.burst is None:
            self.burst = float(self.target_bpp)
        if self.burst < 0:
            raise ValueError(f"burst must be >= 0, got {self.burst}")

    def frame_budget(self) -> float:
        """The budget the NEXT frame may spend (target + carried credit).

        Carried debt (negative credit, see :meth:`update`) shrinks the
        budget, but never below a small positive floor — the per-frame
        search requires a positive target, and every real coder has a
        per-stream floor (header + terminator bytes) anyway."""
        return max(self.target_bpp + self.credit, 1e-6)

    def update(self, actual_bpp: float) -> None:
        """Record a frame's actual spend.

        The per-frame search is one-sided *when the budget is feasible*;
        when even the coarsest step cannot fit (tiny frames or very low
        targets, where per-channel coder floor bytes dominate) the search
        returns the best-effort overshoot. That overshoot is recorded as
        *debt* (negative credit): later frames repay it, keeping the
        long-run mean pinned to the target instead of crashing the
        sequence encode mid-run. Debt is floored symmetrically with the
        credit cap so one pathological frame cannot starve the rest of
        the sequence indefinitely."""
        budget = self.frame_budget()
        if actual_bpp > budget + 1e-9:
            warnings.warn(
                f"frame spent {actual_bpp:.6f} bpp against a "
                f"{budget:.6f} budget (coder floor likely exceeds the "
                "target); carrying the overshoot as debt",
                RuntimeWarning,
                stacklevel=2,
            )
        # credit accrues only REAL underspend, never a loan: while spends
        # stay within budget the prefix invariant sum(actual) <= n*target
        # holds by induction (the min() cap only forgets surplus). An
        # infeasible overshoot breaks the invariant by at most the
        # overshoot itself and is repaid through the debt floor below.
        self.credit = min(self.credit + self.target_bpp - actual_bpp,
                          self.burst)
        self.credit = max(self.credit, -(self.burst + self.target_bpp))
        self.frames += 1
        self.spent += actual_bpp

    @property
    def mean_bpp(self) -> float:
        """Cumulative mean spend (<= target_bpp by the prefix invariant)."""
        return self.spent / self.frames if self.frames else 0.0

    def reset_credit(self) -> None:
        """Drop carried credit — the per-GOP budget boundary.

        A receiver that tunes in at a random-access point must not depend
        on credit accumulated before it joined: resetting at each GOP
        start makes every GOP's spend satisfy the prefix invariant
        INDEPENDENTLY (``sum(actual in gop[0..k]) <= (k+1)*T``), so any
        suffix of GOPs streams within the channel rate. Forgetting credit
        only tightens the global invariant."""
        self.credit = 0.0
