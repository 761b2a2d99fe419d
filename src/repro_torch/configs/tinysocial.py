"""TinySocial — the paper's own running example (Data definitions 1-2).

Defines the Mugshot.com Dataverse: EmploymentType, MugshotUserType (open),
MugshotMessageType (closed), the two Datasets with their secondary indexes,
and a synthetic data generator scaled for the Table 2-4 benchmarks.
"""

from __future__ import annotations

import datetime as dt
import random
from typing import Dict, List, Tuple

from ..core import adm
from ..storage.dataset import PartitionedDataset

__all__ = ["employment_type", "user_type", "message_type", "build_dataverse",
           "gen_users", "gen_messages", "TAG_VOCAB"]


def employment_type() -> adm.RecordType:
    return adm.RecordType("EmploymentType", (
        adm.Field("organization-name", adm.STRING),
        adm.Field("start-date", adm.DATE),
        adm.Field("end-date", adm.DATE, optional=True),
    ), open=True)


def user_type() -> adm.RecordType:
    address = adm.RecordType("AddressType", (
        adm.Field("street", adm.STRING),
        adm.Field("city", adm.STRING),
        adm.Field("state", adm.STRING),
        adm.Field("zip", adm.STRING),
        adm.Field("country", adm.STRING),
    ), open=False)
    return adm.RecordType("MugshotUserType", (
        adm.Field("id", adm.INT32),
        adm.Field("alias", adm.STRING),
        adm.Field("name", adm.STRING),
        adm.Field("user-since", adm.DATETIME),
        adm.Field("address", address),
        adm.Field("friend-ids", adm.BagType(adm.INT32)),
        adm.Field("employment", adm.OrderedListType(employment_type())),
    ), open=True)


def message_type() -> adm.RecordType:
    return adm.RecordType("MugshotMessageType", (
        adm.Field("message-id", adm.INT32),
        adm.Field("author-id", adm.INT32),
        adm.Field("timestamp", adm.DATETIME),
        adm.Field("in-response-to", adm.INT32, optional=True),
        adm.Field("sender-location", adm.POINT, optional=True),
        adm.Field("tags", adm.BagType(adm.STRING)),
        adm.Field("message", adm.STRING),
    ), open=False)


TAG_VOCAB = ["tpu", "jax", "lsm", "asterix", "bigdata", "nosql", "flwor",
             "hyracks", "algebricks", "feeds", "fuzzy", "spatial", "tonight",
             "coffee", "verona", "mesh", "pallas", "roofline"]

_STATES = ["CA", "WA", "OR", "NV", "AZ", "TX"]
_ORGS = ["Kongreen", "Codetechno", "Zamcorp", "Streettax", "Villa-tech"]


def gen_users(n: int, seed: int = 0) -> List[Dict]:
    rng = random.Random(seed)
    base = dt.datetime(2008, 1, 1)
    users = []
    for i in range(n):
        since = base + dt.timedelta(seconds=rng.randrange(6 * 365 * 86400))
        emp = [{"organization-name": rng.choice(_ORGS),
                "start-date": (since + dt.timedelta(days=30)).date()}]
        if rng.random() < 0.5:
            emp[0]["end-date"] = (since + dt.timedelta(days=400)).date()
        users.append({
            "id": i,
            "alias": f"user{i}",
            "name": f"User Number {i}",
            "user-since": since,
            "address": {
                "street": f"{i} Main St", "city": "Irvine",
                "state": rng.choice(_STATES),
                "zip": f"9{i % 10000:04d}", "country": "USA"},
            "friend-ids": [rng.randrange(n) for _ in range(rng.randrange(5))],
            "employment": emp,
        })
    return users


def gen_messages(n: int, num_users: int, seed: int = 1) -> List[Dict]:
    rng = random.Random(seed)
    base = dt.datetime(2014, 1, 1)
    msgs = []
    for i in range(n):
        ts = base + dt.timedelta(seconds=rng.randrange(120 * 86400))
        msgs.append({
            "message-id": i,
            "author-id": rng.randrange(num_users),
            "timestamp": ts,
            "sender-location": (rng.uniform(33.0, 34.0),
                                rng.uniform(-118.0, -117.0)),
            "tags": rng.sample(TAG_VOCAB, rng.randrange(1, 5)),
            "message": " ".join(rng.choice(TAG_VOCAB)
                                for _ in range(rng.randrange(4, 20))),
        })
    return msgs


def build_dataverse(num_users: int = 200, num_messages: int = 1000,
                    num_partitions: int = 4, flush_threshold: int = 128,
                    with_indexes: bool = True, seed: int = 0
                    ) -> Tuple[adm.Dataverse, Dict[str, PartitionedDataset]]:
    dv = adm.Dataverse("TinySocial")
    ut, mt = dv.create_type(user_type()), dv.create_type(message_type())
    users = PartitionedDataset("MugshotUsers", ut, "id",
                               num_partitions, flush_threshold)
    msgs = PartitionedDataset("MugshotMessages", mt, "message-id",
                              num_partitions, flush_threshold)
    if with_indexes:
        users.create_index("user-since")
        msgs.create_index("timestamp")
        msgs.create_index("author-id")
    for u in gen_users(num_users, seed):
        users.insert(u)
    for m in gen_messages(num_messages, num_users, seed + 1):
        msgs.insert(m)
    dv.create_dataset("MugshotUsers", users)
    dv.create_dataset("MugshotMessages", msgs)
    return dv, {"MugshotUsers": users, "MugshotMessages": msgs}
