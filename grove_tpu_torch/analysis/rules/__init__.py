"""grovelint rule registry over the port's tree. Each module holds one
theme's rules; ALL_RULES is the set ``scripts/torch_lint.py`` runs, GL001 to
GL022 in the JAX package's order (docs/static-analysis.md is the catalog;
GL005 checks torch hygiene here, see ``jaxrules.py``)."""

from grove_tpu_torch.analysis.rules.apiwire import WireRoundTripRule
from grove_tpu_torch.analysis.rules.clocks import BlockingTickRule, ClockDisciplineRule
from grove_tpu_torch.analysis.rules.dirtymask import DirtyMaskRegistrationRule
from grove_tpu_torch.analysis.rules.explainrule import ExplainReadonlyRule
from grove_tpu_torch.analysis.rules.federationrule import FederationStateRule
from grove_tpu_torch.analysis.rules.frontierrule import FrontierStateRule
from grove_tpu_torch.analysis.rules.glassbox import GlassBoxStateRule
from grove_tpu_torch.analysis.rules.grayfail import GrayFailStateRule
from grove_tpu_torch.analysis.rules.jaxrules import JitHygieneRule
from grove_tpu_torch.analysis.rules.ledgerrules import ActMustLogRule
from grove_tpu_torch.analysis.rules.locks import LockOrderRule
from grove_tpu_torch.analysis.rules.observability import EventReasonRule, SpanLeakRule
from grove_tpu_torch.analysis.rules.procrules import ProcessBoundaryRule
from grove_tpu_torch.analysis.rules.scheduling import (
    BrokerGrantRule,
    SchedulableMaskRule,
)
from grove_tpu_torch.analysis.rules.shardrules import ShardInternalsRule
from grove_tpu_torch.analysis.rules.slorules import TimeSeriesStateRule
from grove_tpu_torch.analysis.rules.storepath import (
    StoreLoggedCommitRule,
    StoreWritePathRule,
)
from grove_tpu_torch.analysis.rules.workerrules import WorkerAffinityRule

ALL_RULES = (
    ClockDisciplineRule,  # GL001
    BrokerGrantRule,  # GL002
    SchedulableMaskRule,  # GL003
    StoreWritePathRule,  # GL004
    JitHygieneRule,  # GL005
    EventReasonRule,  # GL006
    SpanLeakRule,  # GL007
    BlockingTickRule,  # GL008
    LockOrderRule,  # GL009
    WireRoundTripRule,  # GL010
    StoreLoggedCommitRule,  # GL011
    DirtyMaskRegistrationRule,  # GL012
    ShardInternalsRule,  # GL013
    FrontierStateRule,  # GL014
    GlassBoxStateRule,  # GL015
    ExplainReadonlyRule,  # GL016
    TimeSeriesStateRule,  # GL017
    WorkerAffinityRule,  # GL018
    ActMustLogRule,  # GL019
    ProcessBoundaryRule,  # GL020
    FederationStateRule,  # GL021
    GrayFailStateRule,  # GL022
)
