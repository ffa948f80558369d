from .coordination import CoordinationService  # noqa: F401
from .elastic import ElasticController, HeartbeatMonitor  # noqa: F401
from .policy import (AdmissionPolicy, ElasticityPolicy,  # noqa: F401
                     FailoverPolicy, LatencyAdmissionPolicy,
                     attach_admission, attach_failover,
                     attach_latency_admission)
