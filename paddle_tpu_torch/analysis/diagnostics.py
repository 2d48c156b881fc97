"""Structured findings produced by the analysis passes — a copy of
``paddle_tpu/analysis/diagnostics.py`` (the port imports nothing of the
JAX package, not even this module, which needs only ``enum``).

The analog of the reference's PADDLE_ENFORCE error strings
(reference: paddle/fluid/platform/enforce.h) lifted to data: each checker
emits ``Finding`` records with a severity, the op/block coordinates, the
variables involved and a fix hint, and the report renders them as
source-level diagnostics instead of a deep traceback from the engine (the
Julia-to-TPU compiler's argument, arXiv:1810.09868 §4).
"""

import enum


class Severity(enum.IntEnum):
    INFO = 0
    WARNING = 1
    ERROR = 2

    def __str__(self):
        return self.name


class Finding:
    """One diagnostic: what is wrong, where, and how to fix it."""

    def __init__(self, severity, pass_name, message, block_idx=None,
                 op_idx=None, op_type=None, var_names=(), hint=None):
        self.severity = Severity(severity)
        self.pass_name = pass_name
        self.message = message
        self.block_idx = block_idx
        self.op_idx = op_idx
        self.op_type = op_type
        self.var_names = tuple(var_names)
        self.hint = hint

    def render(self):
        loc = []
        if self.block_idx is not None:
            loc.append("block %d" % self.block_idx)
        if self.op_idx is not None:
            loc.append("op %d" % self.op_idx)
            if self.op_type:
                loc[-1] += " (%s)" % self.op_type
        where = ", ".join(loc)
        line = "[%s] %s: %s" % (self.severity, self.pass_name, self.message)
        if where:
            line += " [at %s]" % where
        if self.var_names:
            line += " vars=%s" % (list(self.var_names),)
        if self.hint:
            line += "\n    hint: %s" % self.hint
        return line

    def __repr__(self):
        return "Finding(%s, %s, %r)" % (self.severity, self.pass_name,
                                        self.message)


class DiagnosticReport:
    """Ordered collection of findings with severity queries and a text
    renderer."""

    def __init__(self, findings=()):
        self.findings = list(findings)

    def add(self, finding):
        self.findings.append(finding)

    def extend(self, findings):
        self.findings.extend(findings)

    def by_severity(self, severity):
        return [f for f in self.findings if f.severity == severity]

    @property
    def errors(self):
        return self.by_severity(Severity.ERROR)

    @property
    def warnings(self):
        return self.by_severity(Severity.WARNING)

    def has_errors(self):
        return bool(self.errors)

    def render(self, min_severity=Severity.INFO):
        shown = [f for f in self.findings if f.severity >= min_severity]
        if not shown:
            return "verifier: no findings"
        lines = [f.render() for f in
                 sorted(shown, key=lambda f: -int(f.severity))]
        lines.append(
            "verifier: %d error(s), %d warning(s), %d info"
            % (len(self.errors), len(self.warnings),
               len(self.by_severity(Severity.INFO))))
        return "\n".join(lines)

    def raise_on_errors(self):
        if self.has_errors():
            raise VerificationError(self)
        return self

    def __len__(self):
        return len(self.findings)

    def __iter__(self):
        return iter(self.findings)


class VerificationError(RuntimeError):
    """Raised when a verified program carries ERROR-severity findings."""

    def __init__(self, report):
        self.report = report
        super().__init__(
            "program verification failed:\n"
            + report.render(min_severity=Severity.ERROR))
