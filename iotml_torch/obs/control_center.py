"""Platform control center — the C3 / HiveMQ Control Center stand-in
(``iotml.obs.control_center``'s copy over the port's ``Platform``).

The reference operates through two web UIs: Confluent Control Center
(topics/consumers/KSQL at `infrastructure/confluent/README.md:226-241`) and
the HiveMQ Control Center (`infrastructure/hivemq/README.md:21`).  This is
the one-page equivalent for the native platform: a live overview of topics
(offsets/partitions), KSQL queries, connectors, MQTT sessions, and the
metric snapshot — as JSON for machines and a self-refreshing HTML page for
humans.

  GET /            HTML overview (auto-refreshes)
  GET /api/status  the same data as JSON

``connectors`` lists the platform's Kafka Connect connectors and
``car_health`` summarises its car-health twin; a platform built without
Connect (``Platform(connect_port=None)``) shows no connector and no
``car_health``.
"""

from __future__ import annotations

import html
import json

from ..utils.rest import RestServer


class ControlCenter(RestServer):
    """Status UI over a running `cli.up.Platform` (or compatible parts)."""

    def __init__(self, platform, host: str = "127.0.0.1", port: int = 0):
        super().__init__(host, port, name="iotml-control-center")
        self.platform = platform
        self.route("GET", r"/api/status", self._status)
        self.route("GET", r"/", self._page)

    # ------------------------------------------------------------- data
    def snapshot(self) -> dict:
        p = self.platform
        topics = []
        for name in p.broker.topics():
            spec = p.broker.topic(name)
            end = sum(p.broker.end_offset(name, q)
                      for q in range(spec.partitions))
            begin = sum(p.broker.begin_offset(name, q)
                        for q in range(spec.partitions))
            topics.append({"name": name, "partitions": spec.partitions,
                           "messages": end - begin, "end_offset": end})
        queries = [q.describe() for q in p.sql.queries.values()]
        streams = [m.describe() for m in p.sql.sources.values()]
        connect = getattr(p, "connect", None)
        connectors = sorted(connect._configs) if connect is not None \
            else []
        from .metrics import default_registry
        metrics = default_registry.collect()
        out = {
            "endpoints": p.endpoints(),
            "topics": topics,
            "ksql": {"queries": queries, "sources": streams},
            "connectors": connectors,
            "mqtt_sessions": p.mqtt_broker.session_count(),
            "metrics": metrics,
        }
        # car-health digital twin (the predictive-maintenance surface):
        # active alerts by car, latest state from the twin sink
        twin = getattr(p, "car_twin", None)
        if twin is not None:
            # snapshot the dict first: the ConnectServer driver thread
            # upserts concurrently and a live generator would raise
            # "dict changed size during iteration"
            docs = list(twin.docs.values())
            alerts = sorted(
                (d for d in docs if d.get("state") == "ALERT"),
                key=lambda d: d.get("t", 0), reverse=True)
            out["car_health"] = {
                "cars_tracked": len(docs),
                "active_alerts": alerts[:100],
                "n_active": len(alerts),
            }
        return out

    def _status(self, m, body):
        return 200, self.snapshot()

    # ------------------------------------------------------------- page
    def _page(self, m, body):
        s = self.snapshot()
        rows = "".join(
            f"<tr><td>{html.escape(t['name'])}</td>"
            f"<td>{t['partitions']}</td><td>{t['messages']}</td></tr>"
            for t in s["topics"])
        qrows = "".join(
            f"<tr><td>{html.escape(q['id'])}</td>"
            f"<td>{html.escape(q['sink'])}</td></tr>"
            for q in s["ksql"]["queries"])
        mrows = "".join(
            f"<tr><td>{html.escape(k)}</td><td>{v:g}</td></tr>"
            for k, v in sorted(s["metrics"].items()))
        ch = s.get("car_health")
        chsec = ""
        if ch is not None:
            arows = "".join(
                f"<tr><td>{html.escape(str(d.get('car')))}</td>"
                f"<td>{html.escape(str(d.get('source', '')))}</td>"
                f"<td>{d.get('ema', 0):g}</td></tr>"
                for d in ch["active_alerts"])
            chsec = (f"<h2>Car health — {ch['n_active']} active alert(s), "
                     f"{ch['cars_tracked']} cars tracked</h2>"
                     f"<table><tr><th>car</th><th>source</th><th>ema</th>"
                     f"</tr>{arows}</table>")
        page = f"""<!doctype html><html><head><title>iotml control center</title>
<meta http-equiv="refresh" content="3">
<style>body{{font-family:monospace;margin:2em}}table{{border-collapse:collapse;margin:1em 0}}
td,th{{border:1px solid #999;padding:2px 8px;text-align:left}}h2{{margin-bottom:0}}</style>
</head><body>
<h1>iotml control center</h1>
<p>MQTT sessions: {s['mqtt_sessions']} · connectors: {len(s['connectors'])}
· endpoints: {html.escape(json.dumps(s['endpoints']))}</p>
{chsec}
<h2>Topics</h2><table><tr><th>topic</th><th>partitions</th><th>messages</th></tr>{rows}</table>
<h2>KSQL queries</h2><table><tr><th>id</th><th>sink</th></tr>{qrows}</table>
<h2>Metrics</h2><table>{mrows}</table>
</body></html>"""
        return 200, page.encode(), "text/html; charset=utf-8"
