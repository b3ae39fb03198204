"""Structured results of a graph-sanitizer run.

The reference stack surfaces graph-level mistakes at runtime (NaiveEngine
re-runs, thread-safety suites); here every check is static, so the result
is a plain report object the caller can print, assert on, or attach to
the profiler. Severity ladder:

* ``error``   — the graph will misbehave on TPU (recompile storm, host
  sync inside the step, donation that cannot alias);
* ``warning`` — expensive but functional (silent f32 upcast in a bf16
  graph, large baked constant);
* ``info``    — advisory (donatable-but-undonated buffer, pass-through
  output).

``MXNET_ANALYSIS_STRICT=1`` promotes warnings to errors — the CI knob
(see docs/static-analysis.md); per-call ``strict=True`` does the same.
"""

import os

SEVERITIES = ('info', 'warning', 'error')


def strict_enabled():
    """True when the environment asks for warnings-as-errors."""
    return os.environ.get('MXNET_ANALYSIS_STRICT', '0') == '1'


class Finding:
    """One rule hit: (rule, severity, message) plus machine-readable
    context in ``data`` (eqn primitive, byte counts, arg labels...)."""

    __slots__ = ('rule', 'severity', 'message', 'location', 'data')

    def __init__(self, rule, severity, message, location=None, data=None):
        if severity not in SEVERITIES:
            raise ValueError(f'bad severity {severity!r}')
        self.rule = rule
        self.severity = severity
        self.message = message
        self.location = location      # user source "file:line" when known
        self.data = data or {}

    def __repr__(self):
        loc = f' @ {self.location}' if self.location else ''
        return f'[{self.severity}] {self.rule}: {self.message}{loc}'


class AnalysisReport:
    """All findings for one traced graph.

    ``graph_name`` names the linted object (block class / function name),
    ``stats`` carries graph-shape facts (eqn count, const bytes, input
    arity) that the profiler prints alongside the findings.
    """

    def __init__(self, graph_name='<graph>', strict=None):
        self.graph_name = graph_name
        self.findings = []
        self.stats = {}
        self.rules_run = []
        self._strict = strict

    # ------------------------------------------------------------------ build
    def add(self, rule, severity, message, location=None, **data):
        f = Finding(rule, severity, message, location=location, data=data)
        self.findings.append(f)
        return f

    @property
    def strict(self):
        return strict_enabled() if self._strict is None else self._strict

    # ------------------------------------------------------------------ query
    def by_rule(self, rule):
        return [f for f in self.findings if f.rule == rule]

    def _effective(self, f):
        if self.strict and f.severity == 'warning':
            return 'error'
        return f.severity

    @property
    def errors(self):
        return [f for f in self.findings if self._effective(f) == 'error']

    @property
    def warnings(self):
        return [f for f in self.findings if self._effective(f) == 'warning']

    @property
    def infos(self):
        return [f for f in self.findings if f.severity == 'info']

    @property
    def ok(self):
        """No errors (warnings allowed unless strict)."""
        return not self.errors

    def raise_if_errors(self):
        if self.errors:
            from ..base import MXNetError
            raise MXNetError(
                f'graph analysis failed for {self.graph_name}:\n'
                + '\n'.join(f'  {f!r}' for f in self.errors))

    # ----------------------------------------------------------------- render
    def summary(self):
        n_e, n_w, n_i = len(self.errors), len(self.warnings), len(self.infos)
        return (f'{self.graph_name}: {n_e} error(s), {n_w} warning(s), '
                f'{n_i} info(s) over {len(self.rules_run)} rule(s)')

    def __str__(self):
        lines = [f'AnalysisReport[{self.graph_name}]']
        if self.stats:
            facts = ', '.join(f'{k}={v}' for k, v in sorted(
                self.stats.items()))
            lines.append(f'  graph: {facts}')
        if not self.findings:
            lines.append('  clean: no findings '
                         f'({len(self.rules_run)} rules)')
        for f in sorted(self.findings,
                        key=lambda f: -SEVERITIES.index(self._effective(f))):
            lines.append(f'  [{self._effective(f):7s}] {f.rule}: '
                         f'{f.message}'
                         + (f' @ {f.location}' if f.location else ''))
        return '\n'.join(lines)

    def __repr__(self):
        return f'<AnalysisReport {self.summary()}>'
