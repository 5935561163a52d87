"""MQTT topic matching and subscription storage
(``iotml.mqtt.topic_tree``'s copy).

The reference's ingestion front-end is a HiveMQ cluster whose Kafka
extension forwards every publish matching an MQTT *topic filter* into a
Kafka topic (reference `infrastructure/hivemq/kafka-config.yaml:20-29`,
filter `vehicles/sensor/data/#`), and whose load test subscribes six
consumers through a *shared* subscription `$share/consumers/...`
(reference `infrastructure/test-generator/scenario.xml:33-35`).  Both
behaviors live here: spec-correct filter matching (`+` one level, `#`
trailing multi-level, `$`-topics shielded from root wildcards) and a trie
of subscriptions with HiveMQ-style shared-group round-robin delivery.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Tuple

SHARE_PREFIX = "$share/"


def split_share(filter_: str) -> Tuple[Optional[str], str]:
    """(share_group, real_filter) — group is None for ordinary filters."""
    if filter_.startswith(SHARE_PREFIX):
        rest = filter_[len(SHARE_PREFIX):]
        group, sep, real = rest.partition("/")
        if not sep or not group or not real:
            raise ValueError(f"malformed shared subscription: {filter_!r}")
        return group, real
    return None, filter_


def validate_filter(filter_: str) -> None:
    _, real = split_share(filter_)
    if not real:
        raise ValueError("empty topic filter")
    levels = real.split("/")
    for i, lv in enumerate(levels):
        if "#" in lv and (lv != "#" or i != len(levels) - 1):
            raise ValueError(f"'#' must be the final whole level: {filter_!r}")
        if "+" in lv and lv != "+":
            raise ValueError(f"'+' must occupy a whole level: {filter_!r}")


def topic_matches(filter_: str, topic: str) -> bool:
    """MQTT-spec filter matching (without $share handling)."""
    f_levels = filter_.split("/")
    t_levels = topic.split("/")
    # topics beginning with '$' are not matched by filters starting with
    # a wildcard (MQTT 3.1.1 §4.7.2 / MQTT 5 §4.7.2)
    if t_levels[0].startswith("$") and f_levels[0] in ("#", "+"):
        return False
    i = 0
    for i, f in enumerate(f_levels):
        if f == "#":
            return True
        if i >= len(t_levels):
            return False
        if f != "+" and f != t_levels[i]:
            return False
    if len(t_levels) > len(f_levels):
        return False
    return True


class _Node:
    __slots__ = ("children", "subs")

    def __init__(self):
        self.children: Dict[str, _Node] = {}
        # (client_id, share_group) → qos
        self.subs: Dict[Tuple[str, Optional[str]], int] = {}


class TopicTree:
    """Subscription trie: add/remove filters, match a publish topic to
    (client_id, qos) receivers with shared-group round-robin."""

    def __init__(self):
        self._root = _Node()
        self._lock = threading.Lock()
        self._rr: Dict[Tuple[str, str], int] = {}  # (group, filter) → cursor

    def subscribe(self, client_id: str, filter_: str, qos: int = 0) -> None:
        validate_filter(filter_)
        group, real = split_share(filter_)
        with self._lock:
            node = self._root
            for lv in real.split("/"):
                node = node.children.setdefault(lv, _Node())
            node.subs[(client_id, group)] = qos

    def unsubscribe(self, client_id: str, filter_: str) -> bool:
        group, real = split_share(filter_)
        with self._lock:
            node = self._root
            for lv in real.split("/"):
                node = node.children.get(lv)
                if node is None:
                    return False
            return node.subs.pop((client_id, group), None) is not None

    def unsubscribe_all(self, client_id: str) -> None:
        with self._lock:
            stack = [self._root]
            while stack:
                node = stack.pop()
                for key in [k for k in node.subs if k[0] == client_id]:
                    del node.subs[key]
                stack.extend(node.children.values())

    # ------------------------------------------------------------- match
    def _collect(self, node: _Node, levels: List[str], i: int,
                 skip_wild_root: bool, out: List[Tuple[_Node, str]],
                 path: List[str]) -> None:
        if i == len(levels):
            if node.subs:
                out.append((node, "/".join(path)))
            # "sport/#" also matches "sport" (the parent level itself)
            child = node.children.get("#")
            if child is not None and child.subs:
                out.append((child, "/".join(path + ["#"])))
            return
        lv = levels[i]
        for key in (lv, "+", "#"):
            if skip_wild_root and i == 0 and key in ("+", "#"):
                continue
            child = node.children.get(key)
            if child is None:
                continue
            if key == "#":
                if child.subs:
                    out.append((child, "/".join(path + ["#"])))
            else:
                self._collect(child, levels, i + 1, skip_wild_root, out,
                              path + [key])

    def receivers(self, topic: str,
                  is_live=None) -> List[Tuple[str, int]]:
        """All (client_id, granted_qos) that should receive a publish on
        `topic`; each shared group contributes exactly one member, rotated
        per matching filter.

        `is_live(cid) -> bool`, when given, steers shared-group selection:
        the rotation skips to the next LIVE member so an offline persistent
        member does not swallow its share of the group's traffic (HiveMQ
        queues for a shared group only when no member is connected).  Falls
        back to the plain rotation pick when every member is offline."""
        levels = topic.split("/")
        shield = levels[0].startswith("$")
        matched: List[Tuple[_Node, str]] = []
        with self._lock:
            self._collect(self._root, levels, 0, shield, matched, [])
            out: List[Tuple[str, int]] = []
            seen = set()
            for node, filter_str in matched:
                groups: Dict[str, List[Tuple[str, int]]] = {}
                for (cid, group), qos in sorted(node.subs.items(),
                                                key=lambda kv: kv[0][0]):
                    if group is None:
                        if cid not in seen:
                            seen.add(cid)
                            out.append((cid, qos))
                    else:
                        groups.setdefault(group, []).append((cid, qos))
                for group, members in groups.items():
                    cur = self._rr.get((group, filter_str), 0)
                    pick = None
                    for i in range(len(members)):
                        cand = members[(cur + i) % len(members)]
                        if is_live is None or is_live(cand[0]):
                            pick = cand
                            cur = cur + i
                            break
                    if pick is None:  # nobody live: queue at rotation pick
                        pick = members[cur % len(members)]
                    cid, qos = pick
                    self._rr[(group, filter_str)] = cur + 1
                    if cid not in seen:
                        seen.add(cid)
                        out.append((cid, qos))
            return out

    def filters_of(self, client_id: str) -> List[str]:
        out: List[str] = []
        with self._lock:
            stack: List[Tuple[_Node, List[str]]] = [(self._root, [])]
            while stack:
                node, path = stack.pop()
                for (cid, group) in node.subs:
                    if cid == client_id:
                        real = "/".join(path)
                        out.append(f"$share/{group}/{real}" if group else real)
                for lv, child in node.children.items():
                    stack.append((child, path + [lv]))
        return sorted(out)
