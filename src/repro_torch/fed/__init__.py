from repro_torch.fed.api import run
from repro_torch.fed.client import local_sgd, local_sgd_frozen, local_sgd_frozen_clients
from repro_torch.fed.dnn import dnn_error, dnn_logits, dnn_loss, init_dnn
from repro_torch.fed.engine import (
    EngineConfig,
    FusedData,
    FusedTrajectory,
    attack_seed,
    client_seeds,
    fused_eager_run,
    fused_server_state,
    make_fused_segment,
    make_fused_sim,
    make_packed_propose_fn,
    make_train_attack_step,
    sweep_fused_sim,
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
    SweepResult,
    detection_stats,
    fused_inputs,
    run_simulation,
    run_sweep,
    simulate,
    sweep,
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
    run_llm_simulation,
    simulate_llm,
    validate_submission,
)
