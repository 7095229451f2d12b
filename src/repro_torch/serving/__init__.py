from repro_torch.serving.admission import (  # noqa: F401
    AdmissionConfig,
    AdmissionController,
    AdmissionStats,
    AdmissionTicket,
    EngineOverloadedError,
)
from repro_torch.serving.api import (  # noqa: F401
    KofnSpec,
    SelectionRequest,
    SelectionResponse,
    encode_texts,
    problem_from_embeddings,
    problem_from_spec,
)
from repro_torch.serving.calibration import (  # noqa: F401
    BackendCostModel,
    CalibrationProfile,
    calibrate_profile,
    default_profile,
    fit_host_latency,
    mcmc_model,
)
from repro_torch.serving.engine import (  # noqa: F401
    RequestCancelled,
    RequestEvicted,
    ResponseFuture,
    SummarizationEngine,
    SummarizeRequest,
    SummarizeResponse,
)
from repro_torch.serving.recovery import (  # noqa: F401
    RecoveryContext,
    RequestFailed,
    RetryPolicy,
)
from repro_torch.serving.router import (  # noqa: F401
    BackendRouter,
    InfeasibleRoute,
    RouteDecision,
    RouterConfig,
)
