from llmvox_tpu_torch.parallel.mesh import (
    DP_AXIS, EP_AXIS, SP_AXIS, TP_AXIS, Mesh, average_metrics,
    broadcast_from_master, create_mesh, initialize_distributed, is_master)
from llmvox_tpu_torch.parallel.sharding import (batch_seq_sharding,
                                                batch_sharding, replicated)
