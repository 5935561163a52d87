"""Grafana dashboard generation from the metric registry
(``iotml.obs.dashboards``'s copy: the same JSON and ConfigMap from the
same registry).

The reference ships two hand-maintained dashboard JSONs — `hivemq.json`
(35 panels: Kafka-extension write rates, MQTT sessions/packets, overload
protection, JVM) and `devsim.json` (24 panels: connect/publish success-fail
counts and rates) — mounted as labeled ConfigMaps (reference
`infrastructure/hivemq/setup.sh:18-19`, `test-generator/run_scenario.sh:8-10`).
Hand-maintained dashboards drift; here panels are *generated* from the
metric registry, so every metric the framework exports gets a panel and the
dashboard is always in sync with the code.  Output is Grafana dashboard
schema JSON (schemaVersion 16, like the reference's files) accepted by the
dashboard-provisioning ConfigMap flow.
"""

from __future__ import annotations

import json
from typing import List, Optional

from . import metrics as m


def _panel(panel_id: int, title: str, expr: str, x: int, y: int,
           unit: str = "short", w: int = 12, h: int = 8) -> dict:
    return {
        "id": panel_id,
        "type": "graph",
        "title": title,
        "datasource": "Prometheus",
        "gridPos": {"h": h, "w": w, "x": x, "y": y},
        "targets": [{"expr": expr, "refId": "A", "legendFormat": title}],
        "yaxes": [{"format": unit, "show": True},
                  {"format": "short", "show": False}],
        "lines": True,
        "fill": 1,
        "linewidth": 2,
        "nullPointMode": "null",
    }


def _expr_for(metric) -> tuple:
    """(PromQL expr, unit) appropriate to the metric type."""
    if isinstance(metric, m.Histogram):
        return (f"rate({metric.name}_sum[1m]) / rate({metric.name}_count[1m])",
                "s")
    if isinstance(metric, m.Gauge):
        return metric.name, "short"
    return f"rate({metric.name}[1m])", "ops"


#: metric-name prefixes → dashboard family, mirroring the reference's split
#: into `hivemq.json` (broker-side) and `devsim.json` (load-generator)
#: plus the ML family the reference never charted.
FAMILIES = {
    "broker": ("mqtt_", "kafka_extension_"),
    "devsim": ("agent_",),
    "ml": ("iotml_",),
    # the continuous-learning loop + per-car failure detection: trainer
    # rounds/loss, scorer hot-swaps, live verdict quality, car alerts
    "live": ("live_", "car_health_"),
}


def generate_dashboard(title: str = "iotml",
                       registry: Optional[m.Registry] = None,
                       uid: Optional[str] = None,
                       family: Optional[str] = None) -> dict:
    """One dashboard with a panel per registered metric (2 per row).

    `family` restricts to one of FAMILIES' prefix groups — the reference's
    per-concern dashboards; None charts everything."""
    registry = registry or m.default_registry
    panels: List[dict] = []
    names = sorted(registry._metrics) if hasattr(registry, "_metrics") else []
    if family is not None:
        prefixes = FAMILIES[family]
        names = [n for n in names if n.startswith(prefixes)]
    for i, name in enumerate(names):
        metric = registry._metrics[name]
        expr, unit = _expr_for(metric)
        panels.append(_panel(
            panel_id=i + 1,
            title=getattr(metric, "help", "") or name,
            expr=expr,
            x=(i % 2) * 12,
            y=(i // 2) * 8,
            unit=unit))
    return {
        "uid": uid or title,
        "title": title,
        "schemaVersion": 16,
        "version": 1,
        "refresh": "10s",
        "time": {"from": "now-30m", "to": "now"},
        "panels": panels,
        "templating": {"list": []},
        "annotations": {"list": []},
    }


def dashboard_configmap(name: str = "iotml-dashboard",
                        title: str = "iotml",
                        registry: Optional[m.Registry] = None) -> str:
    """The reference's deployment shape: dashboard JSONs wrapped in a
    grafana_dashboard-labeled ConfigMap (setup.sh:18-19) — one JSON per
    family (the reference ships hivemq.json + devsim.json; the ml family
    is the training/serving view it never had) plus the everything view."""
    data = {f"{title}.json": json.dumps(generate_dashboard(title, registry))}
    for fam in FAMILIES:
        dash = generate_dashboard(f"{title}-{fam}", registry, family=fam)
        if dash["panels"]:
            data[f"{title}-{fam}.json"] = json.dumps(dash)
    doc = {
        "apiVersion": "v1",
        "kind": "ConfigMap",
        "metadata": {"name": name,
                     "labels": {"grafana_dashboard": "1"}},
        "data": data,
    }
    return json.dumps(doc, indent=2)


if __name__ == "__main__":
    # emit the dashboard ConfigMap for `kubectl apply -f -` (deploy/README.md):
    # python -m iotml_torch.obs.dashboards
    # Metric families register on component construction; build one of each
    # so the emitted dashboards cover every family the platform can export.
    from ..mqtt.bridge import KafkaBridge
    from ..mqtt.broker import MqttBroker
    from ..mqtt.scenario import EVALUATION_SCENARIO, ScenarioRunner
    from ..stream.broker import Broker

    _mqtt = MqttBroker()
    KafkaBridge(_mqtt, Broker(), partitions=1)
    ScenarioRunner(EVALUATION_SCENARIO, _mqtt)
    print(dashboard_configmap())
