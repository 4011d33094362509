"""RDMA-I/O-level admission control (§5.1).

A window-based in-flight-bytes limiter implemented *on* the merge queue —
no extra queueing layer. While the window is full, posting threads block;
their requests keep sitting in the merge queue, where waiting is productive
(more neighbours arrive ⇒ bigger merges). ``AdmissionHook`` is the paper's
extension point for plugging real congestion-control policies;
``CongestionAwareHook`` is the NP-RDMA-style instantiation: multiplicative
window decrease when observed completion latency inflates over the path's
base latency (a congested or straggling donor holds completions longer),
multiplicative recovery once the episode ends.
"""

from __future__ import annotations

import threading
from typing import Optional

from .descriptors import PAGE_SIZE, AtomicCounter, WCStatus, WorkCompletion
from .hist import LatencyHistogram


class AdmissionHook:
    """Custom policy hook; default is the static window of the prototype."""

    def window_bytes(self, current_window: int) -> int:
        return current_window

    def observe(self, wc: WorkCompletion) -> None:
        """Called once per completion the engine sees (success or error);
        policies that react to measured path state override this."""


class CongestionAwareHook(AdmissionHook):
    """AIMD-style window scaling driven by observed completion latency.

    The hook self-calibrates a base latency: the running minimum of the
    latency *EWMA* from the ``calibration``-th completion on. Minimizing
    over the EWMA (not raw samples) tracks the path's loaded steady state
    — queueing behind a full admission window inflates latency even on a
    healthy path, and that must not read as congestion, while a single
    unloaded-fast completion must not set an unreachably low bar. The
    hook keeps a window *fraction* in ``[min_fraction, 1.0]``:

    * EWMA > ``latency_factor`` x base  ⇒  fraction *= ``shrink``
      (congested path: fewer in-flight bytes, the merge queue keeps
      merging behind the smaller window),
    * otherwise                         ⇒  fraction *= ``grow``
      (episode over: multiplicative re-expansion up to the full window).

    Adjustments happen at most once per ``adjust_every`` observations so
    one burst of late completions cannot slam the window to the floor.

    The hook also consumes the fabric's explicit congestion signal: every
    ``WorkCompletion`` carries an ECN-style mark (``ecn_mult`` > 1 when
    any leg of the path had an active congestion/straggler multiplier).
    With ``ecn_sensitive=True`` a marked ``ecn_mark_fraction`` of the
    adjustment window forces a shrink even while the latency EWMA lags —
    explicit marks lead the latency signal by up to a full EWMA time
    constant, and they cannot be fooled by a polluted calibration
    baseline. Lowering the fraction makes a client shed window *earlier*
    under fabric congestion — how best-effort tenants are made to absorb
    an episode first.

    SLO protection (``protected=True`` + ``p99_target_us``): a protected
    client ignores every congestion signal — marks and EWMA alike — and
    keeps its full window until its OWN observed p99 (a built-in
    ``LatencyHistogram`` over successful completions) exceeds the target.
    This is the admission half of the SLO story: premium windows stay
    untouched while best-effort windows shrink, and only a premium tail
    actually degrading makes premium back off too.
    """

    def __init__(self, shrink: float = 0.5, grow: float = 1.5,
                 latency_factor: float = 3.0, min_fraction: float = 1 / 32,
                 ewma_alpha: float = 0.25, adjust_every: int = 8,
                 calibration: int = 24, ecn_sensitive: bool = True,
                 ecn_mark_fraction: float = 0.5, protected: bool = False,
                 p99_target_us: Optional[float] = None) -> None:
        assert 0.0 < shrink < 1.0 < grow
        assert 0.0 < ecn_mark_fraction <= 1.0
        self.shrink = shrink
        self.grow = grow
        self.latency_factor = latency_factor
        self.min_fraction = min_fraction
        self.ewma_alpha = ewma_alpha
        self.adjust_every = adjust_every
        self.calibration = calibration
        self.ecn_sensitive = ecn_sensitive
        self.ecn_mark_fraction = ecn_mark_fraction
        self.protected = protected
        self.p99_target_us = p99_target_us
        self.latency = LatencyHistogram()
        self._lock = threading.Lock()
        self._fraction = 1.0
        self._base_us: Optional[float] = None
        self._ewma_us: Optional[float] = None
        self._observations = 0
        self._since_adjust = 0
        self._marks_since_adjust = 0
        self.shrinks = AtomicCounter()
        self.grows = AtomicCounter()
        self.ecn_marks = AtomicCounter()

    def observe(self, wc: WorkCompletion) -> None:
        if wc.status is not WCStatus.SUCCESS:
            return                      # error latencies are not path signal
        lat = wc.latency_us
        if lat <= 0.0:
            return
        self.latency.record(lat)
        marked = wc.ecn_mult > 1.0
        if marked:
            self.ecn_marks.add()
        with self._lock:
            self._observations += 1
            a = self.ewma_alpha
            self._ewma_us = lat if self._ewma_us is None \
                else a * lat + (1.0 - a) * self._ewma_us
            if self._observations <= self.calibration \
                    or self._base_us is None:    # calibration=0 configs
                self._base_us = self._ewma_us    # loaded steady-state est.
                if self._observations <= self.calibration:
                    return
            # marks count only after calibration: a blip that ended during
            # calibration must not force a shrink on a clean window
            if marked:
                self._marks_since_adjust += 1
            self._base_us = min(self._base_us, self._ewma_us)
            self._since_adjust += 1
            if self._since_adjust < self.adjust_every:
                return
            # a marked ecn_mark_fraction of the window is congestion even
            # when the latency EWMA has not (yet) crossed the threshold
            ecn_congested = (self.ecn_sensitive
                             and self._marks_since_adjust
                             >= self.ecn_mark_fraction * self.adjust_every)
            self._since_adjust = 0
            self._marks_since_adjust = 0
            congested = (ecn_congested or
                         self._ewma_us > self.latency_factor * self._base_us)
            if congested and self.protected:
                # SLO guard: a protected client backs off only once its
                # own tail contract is actually broken
                congested = (self.p99_target_us is not None
                             and self.latency.percentile(99.0)
                             > self.p99_target_us)
            if congested:
                new = max(self.min_fraction, self._fraction * self.shrink)
                if new < self._fraction:
                    self.shrinks.add()
                self._fraction = new
            elif self._fraction < 1.0:
                self._fraction = min(1.0, self._fraction * self.grow)
                self.grows.add()

    def window_bytes(self, current_window: int) -> int:
        with self._lock:
            return max(PAGE_SIZE, int(current_window * self._fraction))

    @property
    def window_fraction(self) -> float:
        with self._lock:
            return self._fraction

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "window_fraction": self._fraction,
                "base_latency_us": self._base_us,
                "ewma_latency_us": self._ewma_us,
                "shrinks": self.shrinks.value,
                "grows": self.grows.value,
                "ecn_marks": self.ecn_marks.value,
            }
        out["p99_us"] = self.latency.percentile(99.0)
        out["protected"] = self.protected
        if self.p99_target_us is not None:
            out["p99_target_us"] = self.p99_target_us
        return out


class AdmissionController:
    def __init__(self, window_bytes: Optional[int],
                 hook: Optional[AdmissionHook] = None) -> None:
        """``window_bytes=None`` disables admission control entirely."""
        self.window_bytes = window_bytes
        self.hook = hook or AdmissionHook()
        self._in_flight = 0
        self._cv = threading.Condition()
        self.blocked_count = AtomicCounter()

    @property
    def in_flight_bytes(self) -> int:
        with self._cv:
            return self._in_flight

    @property
    def current_limit(self) -> Optional[int]:
        """The effective window after the hook's policy (None = unlimited)."""
        if self.window_bytes is None:
            return None
        return self.hook.window_bytes(self.window_bytes)

    def try_acquire(self, nbytes: int) -> bool:
        """Non-blocking reserve; used by the merge path to decide to wait."""
        if self.window_bytes is None:
            return True
        with self._cv:
            limit = self.hook.window_bytes(self.window_bytes)
            if self._in_flight + nbytes <= limit or self._in_flight == 0:
                self._in_flight += nbytes
                return True
            return False

    def acquire(self, nbytes: int, timeout: Optional[float] = None) -> bool:
        """Blocking reserve (a zero-in-flight poster always proceeds)."""
        if self.window_bytes is None:
            return True
        deadline = None
        with self._cv:
            limit = self.hook.window_bytes(self.window_bytes)
            blocked = False
            while self._in_flight + nbytes > limit and self._in_flight > 0:
                if not blocked:
                    self.blocked_count.add()
                    blocked = True
                if not self._cv.wait(timeout=timeout):
                    return False
                limit = self.hook.window_bytes(self.window_bytes)
            self._in_flight += nbytes
            return True

    def wait_for_space(self, timeout: Optional[float] = None) -> bool:
        """Block until the window has *any* room (merger gate)."""
        if self.window_bytes is None:
            return True
        with self._cv:
            limit = self.hook.window_bytes(self.window_bytes)
            blocked = False
            while self._in_flight >= limit:
                if not blocked:
                    self.blocked_count.add()
                    blocked = True
                if not self._cv.wait(timeout=timeout):
                    return False
                limit = self.hook.window_bytes(self.window_bytes)
            return True

    def release(self, nbytes: int) -> None:
        if self.window_bytes is None:
            return
        with self._cv:
            self._in_flight = max(0, self._in_flight - nbytes)
            self._cv.notify_all()

    def snapshot(self) -> dict:
        """One stats-tree node for the window + its policy hook."""
        out = {
            "blocked": self.blocked_count.value,
            "limit": self.current_limit,
            "in_flight_bytes": self.in_flight_bytes,
        }
        if hasattr(self.hook, "snapshot"):
            out["hook"] = self.hook.snapshot()
        return out
