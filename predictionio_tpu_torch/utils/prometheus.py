"""Prometheus text exposition (no dependencies).

The port's copy of `predictionio_tpu/utils/prometheus.py`
(`CONTENT_TYPE`, `OPENMETRICS_CONTENT_TYPE`, `render_metrics`,
`wants_exemplars`). Both HTTP servers of the port serve `GET /metrics`
in the v0.0.4 text format rendered here, from
`obs.metrics.MetricsRegistry.collect()`. The exemplar suffix renders
only on `?exemplars=1` and only for a sample that carries one (a
histogram bucket an in-trace observation landed in).
"""

from __future__ import annotations

from typing import Iterable, Mapping, Optional, Sequence, Tuple, Union

# (labels, value) — or (name-suffix, labels, value) for histogram
# component samples (_bucket/_sum/_count ride under one family name),
# or (name-suffix, labels, value, exemplar) where exemplar is
# {"labels": {...}, "value": v, "ts": t} rendered as the OpenMetrics
# `# {trace_id="..."} v t` suffix (histogram _bucket lines only)
Sample = Union[Tuple[Optional[Mapping[str, str]], float],
               Tuple[str, Optional[Mapping[str, str]], float],
               Tuple[str, Optional[Mapping[str, str]], float, Mapping]]

# the exposition format version this module renders; callers use it as
# the HTTP Content-Type so header and body can never disagree
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# exemplar-bearing rendering: the classic 0.0.4 text parser
# rejects anything after the value that is not a timestamp, so exemplar
# suffixes are only emitted when the caller asked for the OpenMetrics
# exposition (Accept negotiation or ?exemplars=1) — served under this
# content type and terminated with `# EOF`
OPENMETRICS_CONTENT_TYPE = ("application/openmetrics-text; "
                            "version=1.0.0; charset=utf-8")


def _escape(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(v: str) -> str:
    # HELP lines escape backslash and newline only (no quote context)
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def render_metrics(metrics: Iterable[Tuple[str, str, str,
                                           Sequence[Sample]]],
                   exemplars: bool = False) -> str:
    """metrics: (name, type, help, samples); samples are
    (labels-or-None, value), (suffix, labels-or-None, value), or the
    4-tuple form carrying an exemplar. Returns the exposition text.

    ``exemplars=False`` (the default — every classic-format scrape)
    DROPS exemplar suffixes: the 0.0.4 parser rejects them and one
    suffix would fail the whole scrape. ``exemplars=True`` renders
    them on ``_bucket`` lines and terminates the body with the
    OpenMetrics ``# EOF`` marker; serve it under
    :data:`OPENMETRICS_CONTENT_TYPE`."""
    out = []
    for name, mtype, help_, samples in metrics:
        out.append(f"# HELP {name} {_escape_help(help_)}")
        out.append(f"# TYPE {name} {mtype}")
        for sample in samples:
            exemplar = None
            if len(sample) == 4:
                suffix, labels, value, exemplar = sample
            elif len(sample) == 3:
                suffix, labels, value = sample
            else:
                labels, value = sample
                suffix = ""
            lab = ""
            if labels:
                inner = ",".join(f'{k}="{_escape(v)}"'
                                 for k, v in labels.items())
                lab = "{" + inner + "}"
            line = f"{name}{suffix}{lab} {value}"
            if exemplars and exemplar and suffix == "_bucket":
                # OpenMetrics exemplar suffix: the same label-escaping
                # rules as sample labels, exemplar value, then its
                # unix timestamp. Deliberately restricted to _bucket
                # lines — exemplars on _sum/_count are not legal.
                ex_inner = ",".join(
                    f'{k}="{_escape(v)}"'
                    for k, v in (exemplar.get("labels") or {}).items())
                line += (" # {" + ex_inner + "} "
                         + f"{exemplar['value']}")
                ts = exemplar.get("ts")
                if ts is not None:
                    line += f" {round(float(ts), 3)}"
            out.append(line)
    tail = "\n# EOF\n" if exemplars else "\n"
    return "\n".join(out) + tail


def wants_exemplars(req) -> bool:
    """Shared /metrics switch: the exemplar-bearing exposition is
    STRICTLY ``?exemplars=1`` opt-in. Deliberately NOT Accept-header
    negotiated: stock Prometheus advertises openmetrics-text in every
    default Accept header, and this registry's counter families are
    registered with ``_total`` already in the family name — valid in
    the classic format, rejected by a strict OpenMetrics parser
    (which wants ``<family>_total`` samples under a suffix-free
    family) — so honoring the header would hand the default scraper a
    body it may refuse whole. Operators and tooling that want the
    trace-id exemplars ask for them explicitly."""
    params = getattr(req, "params", None) or {}
    return str(params.get("exemplars", "")).lower() in (
        "1", "true", "yes")
