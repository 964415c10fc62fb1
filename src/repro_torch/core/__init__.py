"""Robust aggregation: AFA (Algorithm 1), the baseline rules, reputation.

Importing the package registers every ported rule in ``RULES``.
"""

from repro_torch.core.baselines import (
    RULES,
    AggResult,
    RuleOptions,
    RuleSpec,
    bulyan_aggregate,
    comed_aggregate,
    dispatch_rule,
    dispatch_rule_tree,
    fa_aggregate,
    mkrum_aggregate,
    norm_clip_aggregate,
    pairwise_sq_dists,
    register_rule,
    trimmed_mean_aggregate,
)
from repro_torch.core.afa import (
    AFAConfig,
    AFAResult,
    TreeShards,
    afa_aggregate,
    afa_aggregate_tree,
)
from repro_torch.core.extra_rules import (
    centered_clip_aggregate,
    geometric_median_aggregate,
    zeno_aggregate,
)
from repro_torch.core.reputation import (
    ReputationState,
    betainc,
    block_probability,
    blocked_by_table,
    blocking_table,
    gather_reputation,
    init_reputation,
    mark_blocked_round,
    min_rounds_to_block,
    p_good,
    scatter_reputation,
    update_reputation,
    update_reputation_weighted,
)
from repro_torch.core.stats import masked_mean, masked_median, masked_std
