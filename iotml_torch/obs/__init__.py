"""iotml_torch.obs — observability (``iotml.obs``'s twin): the metrics
registry and its ``/metrics`` + ``/healthz`` server (``metrics``), record
tracing (``tracing``), event-time watermarks (``watermark``), profiler
captures on ``torch.profiler`` (``profile``) and the span-log CLI
(``python -m iotml_torch.obs trace``).  The SLO engine, the TSDB, fleet
federation, dashboards and the canary are ROADMAP A13."""
