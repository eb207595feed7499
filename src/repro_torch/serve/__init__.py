"""Forest serving of the port (counterpart of ``repro.serve``'s forest
stack): ``pack`` -- int8/int16 packed node tables and their byte model,
``registry`` -- the multi-tenant gather-routed model registry, ``degrade``
-- admission, deadlines, retries and the circuit breaker, ``batching`` --
the bucketed micro-batch server, one CUDA graph per (bucket, model-set
shape).  The reference's LM serving (``serve.serve``) is not ported."""
from repro_torch.serve.pack import (  # noqa: F401
    FAT_STEP_BYTES, LABEL_BYTES, PackedForest, pack_stacked, pack_trees,
    predict_record_bytes, unpack, walk_bytes_per_request,
)
from repro_torch.serve.registry import (  # noqa: F401
    ModelRegistry, Tenant, routed_forest_walk,
)
from repro_torch.serve.degrade import (  # noqa: F401
    AdmissionPolicy, CircuitBreaker, DeadlineExceededError,
    NonFiniteOutputError, QueueFullError, RetriesExhaustedError,
    ServeError, TenantUnavailableError, TransientServeError,
)
from repro_torch.serve.batching import (  # noqa: F401
    BatchPolicy, ForestServer, PendingRequest,
)
