"""The public names the port's modules had lacked, against the JAX
package's: `core`'s exports (`AverageServing`, `PAlgorithm`,
`PersistentModel`, `PersistentModelLoader`, `PersistentModelManifest`,
`RETRAIN`, `WorkflowParams`, `params_to_json`, `params_from_json`),
`data/aggregator.merge_aggregations`, `data/bimap.EntityMap`,
`models.list_engine_factories` and
`workflow/create_workflow.workflow_params_from_config`, each fed the
same inputs in both packages. Outputs are compared exactly.
"""

import dataclasses
import datetime as dt
from typing import Optional, Tuple

import pytest

import predictionio_tpu.core as JCORE
import predictionio_tpu_torch.core as TCORE


@pytest.mark.parametrize("name", sorted(JCORE.__all__))
def test_core_exports_every_reference_name(name):
    assert name in TCORE.__all__
    assert hasattr(TCORE, name)


@pytest.mark.parametrize("preds", [[1.0, 2.0, 4.5], [3], [-1.0, 1.0],
                                   [2.5, 2.5, 2.5, 7.0]])
def test_average_serving(preds):
    assert TCORE.AverageServing().serve(None, preds) == \
        JCORE.AverageServing().serve(None, preds)


def test_placements_match_the_reference():
    for name in ("LAlgorithm", "P2LAlgorithm", "PAlgorithm"):
        assert getattr(TCORE, name).placement == \
            getattr(JCORE, name).placement
    with pytest.raises(NotImplementedError):
        TCORE.PAlgorithm.batch_predict(None, None, [])


def _params_class(base):
    @dataclasses.dataclass(frozen=True)
    class P(base):
        rank: int = 10
        lam: float = 0.01
        name: str = "x"
        seed: Optional[int] = None
        keys: Tuple[str, ...] = ()
    return P


@pytest.mark.parametrize("values", [
    {}, {"rank": 3, "lam": 0.5}, {"name": "é", "seed": 7,
                                  "keys": ["a", "b"]}])
def test_params_json_round_trip(values):
    TP, JP = _params_class(TCORE.Params), _params_class(JCORE.Params)
    t, j = TP(**{k: tuple(v) if k == "keys" else v
                 for k, v in values.items()}), \
        JP(**{k: tuple(v) if k == "keys" else v
              for k, v in values.items()})
    text = TCORE.params_to_json(t)
    assert text == JCORE.params_to_json(j)
    assert TCORE.params_from_json(TP, text) == t
    assert dataclasses.asdict(JCORE.params_from_json(JP, text)) == \
        dataclasses.asdict(TCORE.params_from_json(TP, text))
    assert TCORE.params_to_json(None) == JCORE.params_to_json(None) == "{}"
    with pytest.raises(ValueError):
        TCORE.params_from_json(TP, '{"nope": 1}')


def _events(Event, DataMap):
    t0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
    rows = [("$set", "u1", {"a": 1, "b": 2}, 0),
            ("$set", "u2", {"a": 5}, 1),
            ("$unset", "u1", {"b": None}, 2),
            ("$set", "u1", {"c": 3}, 3),
            ("$delete", "u2", {}, 4),
            ("$set", "u3", {"z": [1, 2]}, 5)]
    return [Event(event=e, entity_type="user", entity_id=u,
                  properties=DataMap(p),
                  event_time=t0 + dt.timedelta(seconds=s))
            for e, u, p, s in rows]


@pytest.mark.parametrize("split", [1, 2, 3, 6])
def test_merge_aggregations(split):
    from predictionio_tpu.data import DataMap as JDataMap
    from predictionio_tpu.data import Event as JEvent
    from predictionio_tpu.data import aggregator as JAgg
    from predictionio_tpu_torch.data import aggregator as TAgg
    from predictionio_tpu_torch.data.datamap import DataMap
    from predictionio_tpu_torch.data.event import Event

    def parts(mod, evs):
        out = []
        for lo in range(0, len(evs), split):
            part = {}
            for e in evs[lo:lo + split]:
                op = mod.EventOp.from_event(e)
                prev = part.get(e.entity_id)
                part[e.entity_id] = op if prev is None else prev.merge(op)
            out.append(part)
        return out

    got = TAgg.merge_aggregations(parts(TAgg, _events(Event, DataMap)))
    ref = JAgg.merge_aggregations(parts(JAgg, _events(JEvent, JDataMap)))
    assert sorted(got) == sorted(ref)
    for k in got:
        g, r = got[k].to_property_map(), ref[k].to_property_map()
        assert (g is None) == (r is None)
        if g is not None:
            assert g.fields == r.fields
            assert g.first_updated == r.first_updated
            assert g.last_updated == r.last_updated


def test_entity_map():
    from predictionio_tpu.data.bimap import EntityMap as JMap
    from predictionio_tpu_torch.data.bimap import EntityMap as TMap
    data = {"b": 2.0, "a": {"x": 1}, "c": [3]}
    t, j = TMap(data), JMap(data)
    assert len(t) == len(j) == 3
    for k in data:
        assert (k in t) and t[k] == j[k]
    assert "zz" not in t
    for ix in range(3):
        assert t.get_by_index(ix) == j.get_by_index(ix)
        assert t.ix_map.id_of(ix) == j.ix_map.id_of(ix)


def test_list_engine_factories():
    from predictionio_tpu.models import list_engine_factories as jlist
    from predictionio_tpu_torch.models import list_engine_factories
    assert list_engine_factories() == jlist()


@pytest.mark.parametrize("kw", [{}, {"batch": "nightly", "verbosity": 3},
                                {"skip_sanity_check": True,
                                 "stop_after_read": True},
                                {"stop_after_prepare": True}])
def test_workflow_params_from_config(kw):
    from predictionio_tpu.workflow import create_workflow as JW
    from predictionio_tpu_torch.workflow import create_workflow as TW
    got = TW.workflow_params_from_config(TW.WorkflowConfig(**kw))
    ref = JW.workflow_params_from_config(JW.WorkflowConfig(**kw))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert isinstance(got, TCORE.WorkflowParams)
