from repro_torch.utils.trees import (
    LeafSlot,
    PackSpec,
    pack_spec,
    pack_stack,
    tree_broadcast_clients,
    tree_leaves,
    tree_map,
    tree_select_rows,
    tree_stack,
    tree_structure,
    tree_unflatten,
    unpack_stack,
)
