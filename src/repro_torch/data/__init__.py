from repro_torch.data.sharding import dirichlet_shards, iid_shards, padded_stack
from repro_torch.data.synthetic import (
    SyntheticClassification,
    TokenStream,
    make_mnist_like,
    make_spambase_like,
    make_token_stream,
)
