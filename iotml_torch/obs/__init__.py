"""iotml_torch.obs — observability (``iotml.obs``'s twin): the metrics
registry and its ``/metrics`` + ``/healthz`` server (``metrics``), record
tracing (``tracing``), event-time watermarks (``watermark``), profiler
captures on ``torch.profiler`` (``profile``), the synthetic e2e canary
(``canary``), fleet federation (``federate``), the log-native TSDB
(``tsdb``), burn-rate SLOs (``slo``), the alert-burn drill (``drill``),
Grafana dashboards (``dashboards``), the control center
(``control_center``), scalar logs (``tb``) and the CLI
(``python -m iotml_torch.obs``)."""

from .tb import ScalarLogger, TorchProfiler

__all__ = ["ScalarLogger", "TorchProfiler"]
