"""Engine-template gallery: the built-in families and a URI-addressed
remote index.

The port's copy of `predictionio_tpu/tools/templates.py`, the reference's
GitHub-backed template tool (Template.scala:130-416, `pio template
list/get`: a templates.json index, a tarball download, an extract). Two
sources:

  - the built-in template families (`get` scaffolds an engine directory
    whose `engine.json` names one of the port's engine factories);
  - a gallery at a URI (`PIO_TEMPLATE_GALLERY` or `template --gallery`):
    `<root>/index.json` lists `{"templates": [{"name", "description",
    "archive"}]}`, and each archive is a .tar.gz read through the model
    store's scheme registry (`data/storage/remotefs.adapter_for`;
    `file://` built in, other schemes plug in with `register_scheme`)
    and extracted with path-traversal protection.

`TEMPLATES` holds the reference's params plus the port's own: every
algorithm names `"device": null` (the card; `"cpu"` runs on the CPU),
and the recommendation and similar-product ALS also name `"solver":
"auto"` (the CG kernel on the card).
"""

from __future__ import annotations

import io
import json
import os
import posixpath
import tarfile

TEMPLATES = {
    "recommendation": {
        "description": "Explicit-ALS personalized recommendation "
                       "(rate/buy events)",
        "engine_json": {
            "id": "default",
            "description": "Default settings",
            "engineFactory": "recommendation",
            "datasource": {"params": {"app_name": "MyApp"}},
            "preparator": {"params": {"dedup": "latest"}},
            "algorithms": [{"name": "als", "params": {
                "rank": 10, "num_iterations": 20, "lam": 0.01, "seed": 3,
                "solver": "auto", "device": None}}],
        },
        "query_example": {"user": "1", "num": 4},
    },
    "classification": {
        "description": "Naive-bayes classification over $set user "
                       "properties",
        "engine_json": {
            "id": "default",
            "description": "Default settings",
            "engineFactory": "classification",
            "datasource": {"params": {"app_name": "MyApp", "eval_k": 5}},
            "algorithms": [{"name": "naive", "params": {
                "lam": 1.0, "device": None}}],
        },
        "query_example": {"attr0": 2, "attr1": 0, "attr2": 0},
    },
    "similarproduct": {
        "description": "Implicit-ALS similar-item recommendation "
                       "(view events)",
        "engine_json": {
            "id": "default",
            "description": "Default settings",
            "engineFactory": "similarproduct",
            "datasource": {"params": {"app_name": "MyApp"}},
            "algorithms": [{"name": "als", "params": {
                "rank": 10, "num_iterations": 20, "lam": 0.01,
                "alpha": 1.0, "seed": 3, "solver": "auto",
                "device": None}}],
        },
        "query_example": {"items": ["i1"], "num": 4},
    },
    "recommendeduser": {
        "description": "Implicit-ALS similar-user recommendation "
                       "(follow events)",
        "engine_json": {
            "id": "default",
            "description": "Default settings",
            "engineFactory": "recommendeduser",
            "datasource": {"params": {"app_name": "MyApp"}},
            "algorithms": [{"name": "als", "params": {
                "rank": 10, "num_iterations": 20, "lam": 0.01, "seed": 3,
                "device": None}}],
        },
        "query_example": {"users": ["u1"], "num": 4},
    },
    "ecommercerecommendation": {
        "description": "ALS + live business rules (seen-item/"
                       "unavailable-item blacklists)",
        "engine_json": {
            "id": "default",
            "description": "Default settings",
            "engineFactory": "ecommercerecommendation",
            "datasource": {"params": {"app_name": "MyApp"}},
            "algorithms": [{"name": "ecomm", "params": {
                "app_name": "MyApp", "unseen_only": True,
                "seen_events": ["buy", "view"], "rank": 10,
                "num_iterations": 20, "lam": 0.01, "alpha": 1.0,
                "seed": 3, "device": None}}],
        },
        "query_example": {"user": "u1", "num": 4},
    },
}


class GalleryError(RuntimeError):
    pass


def _gallery_uri(gallery=None):
    return gallery or os.environ.get("PIO_TEMPLATE_GALLERY") or None


def _gallery_index(uri: str):
    """[{name, description, archive}] from <uri>/index.json. Every field
    is remote content: parse failures and unsafe archive paths become
    GalleryError, never tracebacks."""
    from predictionio_tpu_torch.data.storage.remotefs import adapter_for
    adapter, root = adapter_for(uri)
    p = posixpath.join(root, "index.json")
    if not adapter.exists(p):
        raise GalleryError(f"no index.json at gallery {uri}")
    try:
        idx = json.loads(adapter.read(p).decode("utf-8"))
    except ValueError as e:
        raise GalleryError(f"index.json at {uri} is not valid JSON: {e}")
    out = []
    for e in idx.get("templates", []):
        if not isinstance(e, dict) or not e.get("name") \
                or not e.get("archive"):
            raise GalleryError(f"gallery entry missing name/archive: {e}")
        arc = e["archive"]
        if (arc.startswith(("/", "\\")) or ".." in arc.split("/")
                or (len(arc) > 1 and arc[1] == ":")):
            # the index must not reach outside its own root
            raise GalleryError(f"unsafe archive path {arc!r} in index")
        out.append(e)
    return out


def _safe_extract(data: bytes, directory: str) -> int:
    """Extract a .tar.gz, refusing absolute paths, parent escapes, links,
    and devices (the index is remote content — never trust member
    names). ALL members are validated before anything is written, so a
    rejected archive leaves no partial, plausible-looking engine
    directory behind. Returns the number of files written."""
    try:
        with tarfile.open(fileobj=io.BytesIO(data), mode="r:gz") as tf:
            members = tf.getmembers()      # parses every header up front
            for m in members:
                name = m.name
                if (name.startswith(("/", "\\"))
                        or ".." in name.split("/")
                        or (len(name) > 1 and name[1] == ":")):
                    raise GalleryError(f"unsafe archive member {name!r}")
                if not (m.isdir() or m.isreg()):
                    raise GalleryError(
                        f"archive member {name!r} is not a regular file "
                        f"(links/devices are refused)")
            n = 0
            for m in members:
                if m.isdir():
                    os.makedirs(os.path.join(directory, m.name),
                                exist_ok=True)
                    continue
                dst = os.path.join(directory, m.name)
                os.makedirs(os.path.dirname(dst) or directory,
                            exist_ok=True)
                src = tf.extractfile(m)
                with open(dst, "wb") as f:
                    f.write(src.read())
                n += 1
            return n
    except tarfile.TarError as e:
        raise GalleryError(f"archive is not a valid tar.gz: {e}")


def list_templates(gallery=None):
    """Built-ins plus, when a gallery URI is configured, its index
    entries (gallery wins on name collisions, as the reference's remote
    index shadows nothing local — there was nothing local there)."""
    out = {name: t["description"] for name, t in TEMPLATES.items()}
    uri = _gallery_uri(gallery)
    if uri:
        for e in _gallery_index(uri):
            out[e["name"]] = ((e.get("description") or "")
                              + f" [gallery {uri}]")
    return sorted(out.items())


def get_template(name: str, directory: str, gallery=None) -> int:
    uri = _gallery_uri(gallery)
    if uri:
        entries = {e["name"]: e for e in _gallery_index(uri)}
        if name in entries:
            from predictionio_tpu_torch.data.storage.remotefs import adapter_for
            adapter, root = adapter_for(uri)
            blob = posixpath.join(root, entries[name]["archive"])
            if not adapter.exists(blob):
                raise GalleryError(
                    f"gallery index names {entries[name]['archive']!r} "
                    f"but the blob is missing at {uri}")
            os.makedirs(directory, exist_ok=True)
            n = _safe_extract(adapter.read(blob), directory)
            print(f"Engine template {name} created in {directory} "
                  f"({n} file(s) from {uri}).")
            return 0
    if name not in TEMPLATES:
        print(f"Unknown template {name!r}. Try `template list`.")
        return 1
    t = TEMPLATES[name]
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "engine.json"), "w") as f:
        json.dump(t["engine_json"], f, indent=2)
        f.write("\n")
    with open(os.path.join(directory, "README.md"), "w") as f:
        f.write(f"""# {name} engine

{t['description']}

## Usage

    python -m predictionio_tpu_torch app new MyApp   # note the key
    # ... send events to the event server (eventserver) ...
    python -m predictionio_tpu_torch train -v engine.json
    python -m predictionio_tpu_torch deploy -v engine.json --port 8000

    curl -H 'Content-Type: application/json' \\
      -d '{json.dumps(t['query_example'])}' \\
      http://localhost:8000/queries.json
""")
    print(f"Engine template {name} created in {directory}.")
    return 0
