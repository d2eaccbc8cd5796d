"""Exceptions (parity with reference ``littlemcmc/exceptions.py:22-25``)."""

__all__ = ["SamplingError", "IntegrationError", "ParallelSamplingError"]


class SamplingError(RuntimeError):
    """Error while sampling."""


class IntegrationError(RuntimeError):
    """Numerical errors during leapfrog integration.

    Kept for API parity with the reference (``integration.py:28-31``); the
    on-device integrator never raises it — non-finite values propagate through
    divergence masks instead.
    """


class ParallelSamplingError(Exception):
    """Error in a parallel chain (reference ``parallel_sampling.py:32-38``).

    Kept for API parity. The reference raises it when a worker process
    dies; here chains are vectorized in one device program, so per-chain
    failures surface as divergence masks / ``SamplerWarning``s instead,
    and whole-program failures raise their original exception.
    """

    def __init__(self, message, chain=None, warnings=None):
        super().__init__(message)
        self.message = message
        self.chain = chain
        self.warnings = warnings or []
