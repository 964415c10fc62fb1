from repro_torch.data.sharding import (
    compact_stack,
    dirichlet_shards,
    iid_shards,
    padded_stack,
    pow2_bucket,
    shard_compact_plan,
)
from repro_torch.data.synthetic import (
    SyntheticClassification,
    TokenStream,
    make_mnist_like,
    make_spambase_like,
    make_token_stream,
)
