"""Host-side telemetry: metrics registry, lifecycle tracing, MFU.

The counterpart of ``repro/obs``. Three pillars, all host-side Python
around the steps; attaching any of them adds no kernel launch and no host
synchronisation (``tests/test_torch_obs.py`` counts the aten calls with
them on and off):

  * :mod:`repro_torch.obs.metrics` -- counters / gauges / fixed-bucket
    histograms behind one registry with a flat-dict ``snapshot()``
    schema. Both serving engines, the KV page pool, the kv-split knob
    resolution and the train loop register into it.
  * :mod:`repro_torch.obs.trace` -- span-based request-lifecycle and
    train-step event log exported as Chrome/Perfetto ``trace_event``
    JSON (``--trace-out`` on launch/serve.py and launch/train.py).
  * :mod:`repro_torch.obs.mfu` -- analytic model FLOPs (utils/flops) and
    the visible-tile census folded into live MFU, HFU and tokens/s
    gauges for train and decode.
"""

from repro_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    count_knob,
    default_registry,
    reset_default_registry,
)
from repro_torch.obs.mfu import (  # noqa: F401
    DecodeEfficiency,
    TrainEfficiency,
    peak_flops,
)
from repro_torch.obs.trace import (  # noqa: F401
    TraceRecorder,
    validate_trace,
)
