"""The port's query/: JSON query pushdown, held to the JAX package's
query/ on the same bytes, and the volume server's /admin/query.

The query cases of tests/test_images_query.py pointed at the port and
its volume server (tests/test_torch_cluster_util.py). Reference
behaviors: weed/query/json/query_json.go + server/volume_grpc_query.go.
"""

import json

import pytest

from test_torch_cluster_util import Cluster, run

from seaweedfs_tpu.query import Filter as RefFilter
from seaweedfs_tpu.query import query_json as ref_query_json
from seaweedfs_tpu_torch.query import Filter, query_json

RECORDS = b"\n".join(json.dumps(r).encode() for r in [
    {"name": "a", "age": 30, "addr": {"city": "sf"}},
    {"name": "b", "age": 10, "addr": {"city": "nyc"}},
    {"name": "c", "age": 25, "addr": {"city": "sf"}},
])


def test_query_json_filter_and_projection():
    got = query_json(RECORDS, Filter("age", ">", "20"),
                     ["name", "addr.city"])
    assert got == [{"name": "a", "addr.city": "sf"},
                   {"name": "c", "addr.city": "sf"}]
    # string equality + like
    got = query_json(RECORDS, Filter("addr.city", "=", "nyc"), ["name"])
    assert got == [{"name": "b"}]
    got = query_json(RECORDS, Filter("name", "like", "a"), None)
    assert got[0]["age"] == 30
    # whole-body JSON array form
    arr = json.dumps([{"x": 1}, {"x": 2}]).encode()
    assert query_json(arr, Filter("x", ">=", "2"), ["x"]) == [{"x": 2}]


@pytest.mark.parametrize("field,op,value,sel", [
    ("age", ">", "20", ["name", "addr.city"]),
    ("age", "<=", "25", None),
    ("addr.city", "=", "sf", ["name"]),
    ("addr.city", "!=", "sf", ["age"]),
    ("name", "like", "b", None),
    ("missing", "=", "x", ["name"]),
])
def test_query_json_equals_reference(field, op, value, sel):
    assert query_json(RECORDS, Filter(field, op, value), sel) == \
        ref_query_json(RECORDS, RefFilter(field, op, value), sel)


def test_volume_server_query(tmp_path):
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            a = await c.assign()
            async with c.http.post(
                    f"http://{a['url']}/{a['fid']}", data=b"{}",
                    headers={"Content-Type": "application/json"}) as resp:
                assert resp.status == 201
            # unknown query operand: clean 400
            async with c.http.post(
                    f"http://{a['url']}/admin/query",
                    json={"fromFileIds": [a["fid"]],
                          "filter": {"field": "x", "operand": "~",
                                     "value": "1"}}) as resp:
                assert resp.status == 400

            # JSON records + query pushdown
            recs = [{"user": "u1", "n": i} for i in range(5)]
            a2 = await c.assign()
            body_json = "\n".join(json.dumps(r) for r in recs).encode()
            async with c.http.post(
                    f"http://{a2['url']}/{a2['fid']}", data=body_json,
                    headers={"Content-Type": "application/json"}) as resp:
                assert resp.status == 201
            q = {"fromFileIds": [a2["fid"]],
                 "filter": {"field": "n", "operand": ">=", "value": "3"},
                 "selections": ["n"]}
            async with c.http.post(
                    f"http://{a2['url']}/admin/query", json=q) as resp:
                assert resp.status == 200
                lines = [json.loads(x) for x in
                         (await resp.text()).strip().splitlines()]
            assert lines == [{"n": 3}, {"n": 4}]
    run(body())
