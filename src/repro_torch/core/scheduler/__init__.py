from repro_torch.core.scheduler.base import (
    Policy, SchedView, chips_for_frac, speculation_worthwhile)
from repro_torch.core.scheduler.baselines import (
    FixedBatchMPSPolicy, GSLICEPolicy, MaxMinPolicy, MaxThroughputPolicy,
    TemporalPolicy, TritonPolicy)
from repro_torch.core.scheduler.dstack import DStackPolicy
from repro_torch.core.scheduler.ideal import IdealSimulator

POLICIES = {
    "temporal": TemporalPolicy,
    "fixed_batch_mps": FixedBatchMPSPolicy,
    "gslice": GSLICEPolicy,
    "triton": TritonPolicy,
    "maxmin": MaxMinPolicy,
    "max_throughput": MaxThroughputPolicy,
    "dstack": DStackPolicy,
}

__all__ = [
    "Policy", "SchedView", "chips_for_frac", "speculation_worthwhile",
    "POLICIES", "TemporalPolicy",
    "FixedBatchMPSPolicy", "GSLICEPolicy", "TritonPolicy", "MaxMinPolicy",
    "MaxThroughputPolicy", "DStackPolicy", "IdealSimulator",
]
