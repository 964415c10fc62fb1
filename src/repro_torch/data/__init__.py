from repro_torch.data.sharding import dirichlet_shards, iid_shards
from repro_torch.data.synthetic import (
    SyntheticClassification,
    make_mnist_like,
    make_spambase_like,
)
