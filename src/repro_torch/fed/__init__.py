from repro_torch.fed.api import run
from repro_torch.fed.client import local_sgd, local_sgd_frozen
from repro_torch.fed.dnn import dnn_error, dnn_logits, dnn_loss, init_dnn
from repro_torch.fed.engine import (
    EngineConfig,
    FusedData,
    FusedTrajectory,
    attack_seed,
    client_seeds,
    fused_server_state,
    make_fused_segment,
    make_fused_sim,
    make_packed_propose_fn,
    make_train_attack_step,
)
from repro_torch.fed.server import (
    FedServer,
    ServerConfig,
    ServerState,
    gather_server_state,
    init_server_state,
    make_rule_options,
    resolve_server_plan,
    scatter_server_state,
    server_step,
    server_step_versioned,
)
from repro_torch.fed.simulator import (
    FusedInputs,
    SimConfig,
    SimResult,
    detection_stats,
    fused_inputs,
    simulate,
)
from repro_torch.fed.workload import (
    ADAPTER_CODEC,
    IDENTITY_CODEC,
    WORKLOADS,
    ClientWorkload,
    DnnWorkload,
    ProposalCodec,
    TransformerLoraWorkload,
    get_workload,
    init_lora_adapters,
    make_llm_fused_data,
    merge_lora,
    simulate_llm,
    validate_submission,
)
