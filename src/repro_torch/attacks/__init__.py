from repro_torch.attacks.attacks import (
    UPDATE_ATTACK_SCENARIOS,
    alie_update_tree,
    apply_update_attack,
    byzantine_update_keyed,
    byzantine_update_tree,
    flip_labels,
    ipm_update_tree,
    noisy_features,
    stream_seed,
)
