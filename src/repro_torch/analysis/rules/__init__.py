"""The port's replint rule registry (the JAX package's ids and names).

Adding a rule: subclass analysis.core.Rule in a new module here, set
id/name/doc, implement check(corpus), and append the class to ALL_RULES.
Rule ids are stable (suppressions reference them); never reuse one.
"""
from repro_torch.analysis.rules.r001_determinism import DeterminismRule
from repro_torch.analysis.rules.r002_bare_jit import BareJitRule
from repro_torch.analysis.rules.r003_retrace import RetraceRule
from repro_torch.analysis.rules.r004_protocol import ProtocolRule
from repro_torch.analysis.rules.r005_metric_schema import MetricSchemaRule
from repro_torch.analysis.rules.r006_tracer import TracerHygieneRule

ALL_RULES = (DeterminismRule, BareJitRule, RetraceRule, ProtocolRule,
             MetricSchemaRule, TracerHygieneRule)

__all__ = ["ALL_RULES", "DeterminismRule", "BareJitRule", "RetraceRule",
           "ProtocolRule", "MetricSchemaRule", "TracerHygieneRule"]
