"""Lock discipline for the threaded host runtime: the declared lock
hierarchy (:mod:`.locks`), the dynamic race checker (:mod:`.race`) and
its report type (:mod:`.report`). The graph linter and cost model of the
JAX package work on traced jaxprs and are not part of the port.
"""

from .report import AnalysisReport, Finding, strict_enabled
from . import locks
from . import race

__all__ = ['AnalysisReport', 'Finding', 'strict_enabled', 'locks', 'race']
