"""Fault injection at named sites.

The part of the JAX package's ``runtime/faults.py`` that
``decision/whatif.py`` uses: a site calls ``maybe_fail("site")`` on its
path; with nothing armed that is one lookup in an empty set. A site
armed with ``registry.arm`` raises ``FaultInjected`` at its next check
(the reference's one-shot schedule) and bumps
``runtime.fault.<site>.fired``.
"""

from __future__ import annotations

from openr_tpu_torch.runtime.counters import counters


class FaultInjected(ConnectionError):
    """Raised by an armed site. Subclasses ConnectionError so transport
    call sites treat it exactly like the I/O failure it simulates."""

    def __init__(self, site: str):
        super().__init__(f"injected fault at {site!r}")
        self.site = site


class FaultRegistry:
    """Process-global table of the sites armed to fire once."""

    def __init__(self):
        self._armed: set[str] = set()

    def arm(self, site: str) -> None:
        """Fire ``FaultInjected`` at the site's next check, once."""
        if not site:
            raise ValueError("fault site name must be non-empty")
        self._armed.add(site)
        counters.increment("runtime.fault.armed")

    def clear(self, site: str) -> None:
        self._armed.discard(site)

    def maybe_fail(self, site: str) -> None:
        if site not in self._armed:
            return
        self._armed.discard(site)
        counters.increment(f"runtime.fault.{site}.fired")
        counters.increment("runtime.fault.fired")
        raise FaultInjected(site)


registry = FaultRegistry()


def maybe_fail(site: str) -> None:
    """Module-level hook; see FaultRegistry.maybe_fail."""
    registry.maybe_fail(site)
