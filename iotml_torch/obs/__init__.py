"""iotml_torch.obs — observability (``iotml.obs``'s twin): the metrics
registry and its ``/metrics`` + ``/healthz`` server (``metrics``), record
tracing (``tracing``), event-time watermarks (``watermark``), profiler
captures on ``torch.profiler`` (``profile``), the span-log CLI
(``python -m iotml_torch.obs trace``) and the synthetic e2e canary
(``canary``).  The SLO engine, the TSDB, fleet federation and dashboards
are ROADMAP A13."""
