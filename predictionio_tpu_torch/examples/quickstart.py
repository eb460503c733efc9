"""End-to-end quickstart for any built-in template family, offline.

The port's copy of `examples/quickstart.py`.

Usage:
    python -m predictionio_tpu_torch.examples.quickstart \
        [recommendation|classification|similarproduct|
         ecommercerecommendation|recommendeduser] [--device cuda|cpu]

Seeds a temporary event store with synthetic events, trains the engine
from `tools/templates.TEMPLATES[family]` through the workflow, deploys
the engine server on a free local port and queries it over HTTP: the
reference quickstart's flow (app new -> events -> train -> deploy ->
query) in one script. The store lives under a fresh `PIO_FS_BASEDIR`;
the `PIO_STORAGE_*` environment still picks the backends, so a
`remotefs` MODELDATA source keeps the model blob at its URL. Every
algorithm runs on `--device` (default: the card).
"""

import argparse
import json
import os
import tempfile
import urllib.request


def seed_events(app_id, family):
    import numpy as np
    from predictionio_tpu_torch.data.datamap import DataMap
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage import Storage
    rng = np.random.default_rng(0)
    ev = Storage.get_events()
    events = []
    if family == "recommendeduser":
        # two follow communities: even users follow even users, odd odd
        for u in range(10):
            events.append(Event(event="$set", entity_type="user",
                                entity_id=f"u{u}"))
        for u in range(10):
            for v in range(10):
                if u != v and u % 2 == v % 2 and rng.random() < 0.8:
                    events.append(Event(
                        event="follow", entity_type="user",
                        entity_id=f"u{u}", target_entity_type="user",
                        target_entity_id=f"u{v}"))
        ev.insert_batch(events, app_id)
        print(f"Seeded {len(events)} events.")
        return
    if family == "classification":
        for j in range(60):
            label = float(j % 2)
            base = [8.0, 1.0, 1.0] if label == 0 else [1.0, 1.0, 8.0]
            events.append(Event(
                event="$set", entity_type="user", entity_id=f"u{j}",
                properties=DataMap({
                    "plan": label,
                    "attr0": base[0] + float(rng.integers(0, 2)),
                    "attr1": base[1], "attr2": base[2]})))
    else:
        for g in range(2):
            for i in range(5):
                events.append(Event(
                    event="$set", entity_type="item", entity_id=f"i{g}{i}",
                    properties=DataMap(
                        {"categories": ["catA" if g == 0 else "catB"]})))
        for u in range(10):
            g = u % 2
            events.append(Event(event="$set", entity_type="user",
                                entity_id=f"u{u}"))
            for i in range(5):
                if rng.random() < 0.8:
                    for name in ("view", "rate"):
                        events.append(Event(
                            event=name, entity_type="user",
                            entity_id=f"u{u}", target_entity_type="item",
                            target_entity_id=f"i{g}{i}",
                            properties=DataMap(
                                {"rating": float(rng.integers(3, 6))}
                                if name == "rate" else {})))
    ev.insert_batch(events, app_id)
    print(f"Seeded {len(events)} events.")


QUERIES = {
    "recommendation": {"user": "u1", "num": 4},
    "classification": {"attr0": 9.0, "attr1": 1.0, "attr2": 1.0},
    "similarproduct": {"items": ["i00"], "num": 4},
    "ecommercerecommendation": {"user": "u1", "num": 4},
    "recommendeduser": {"users": ["u1"], "num": 4},
}


def main(family: str = "recommendation", device="cuda"):
    assert family in QUERIES, f"unknown family {family}"
    tmp = tempfile.mkdtemp(prefix="pio_quickstart_")
    os.environ["PIO_FS_BASEDIR"] = tmp

    from predictionio_tpu_torch.tools.app_commands import app_new
    from predictionio_tpu_torch.tools.templates import TEMPLATES
    from predictionio_tpu_torch.workflow import (WorkflowConfig,
                                           create_workflow_main)
    from predictionio_tpu_torch.serving.server import (EngineServer,
                                                       ServerConfig)

    desc = app_new("MyApp")
    print(f"Created app MyApp (access key {desc.access_keys[0].key[:12]}...)")
    seed_events(desc.app.id, family)

    variant = json.loads(json.dumps(TEMPLATES[family]["engine_json"]))
    variant["datasource"]["params"]["app_name"] = "MyApp"
    for algo in variant["algorithms"]:
        if "num_iterations" in algo["params"]:
            algo["params"]["num_iterations"] = 10
        if "app_name" in algo["params"]:
            algo["params"]["app_name"] = "MyApp"
        algo["params"]["device"] = device
    variant_path = os.path.join(tmp, "engine.json")
    with open(variant_path, "w") as f:
        json.dump(variant, f)

    print("Training...")
    instance_id = create_workflow_main(
        WorkflowConfig(engine_variant=variant_path))
    print(f"Trained engine instance {instance_id}")

    server = EngineServer(ServerConfig(
        ip="127.0.0.1", port=0, engine_instance_id=instance_id))
    server.load()
    server.start()
    try:
        q = QUERIES[family]
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.config.port}/queries.json",
            data=json.dumps(q).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=30) as resp:
            print(f"Query {json.dumps(q)}")
            print(f"Result {resp.read().decode()}")
    finally:
        server.stop()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("family", nargs="?", default="recommendation",
                    choices=sorted(QUERIES))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    main(args.family, args.device)
