"""Carry a reference dataset's state into the port.

In this system data plays the part weights play in a model: a port
query is held against the reference by running both over the same
records.  :func:`dataset_from_reference` reads a reference
``PartitionedDataset`` duck-typed — its record type, primary key,
partition count, flush threshold, merge policy, index declarations and
live records from ``scan()`` — and builds the port's equal dataset.  It
imports nothing of the reference package.
"""

from __future__ import annotations

from typing import Any

from ..core import adm
from ..core.lsm import TieredMergePolicy
from .dataset import PartitionedDataset

__all__ = ["adm_type_from_reference", "dataset_from_reference"]


def adm_type_from_reference(t: Any) -> Any:
    """The port's ADM type equal to a reference ADM type (primitive,
    record, ordered list or bag), matched by class name and tag."""
    kind = type(t).__name__
    if kind == "ADMType":
        return adm._PRIMS_BY_TAG[t.tag]
    if kind == "RecordType":
        return adm.RecordType(t.name, tuple(
            adm.Field(f.name, adm_type_from_reference(f.type), f.optional,
                      f.default) for f in t.fields), open=t.open)
    if kind == "OrderedListType":
        return adm.OrderedListType(adm_type_from_reference(t.item))
    if kind == "BagType":
        return adm.BagType(adm_type_from_reference(t.item))
    raise TypeError(f"no port counterpart for ADM type {t!r}")


def dataset_from_reference(ref: Any) -> PartitionedDataset:
    """The port's dataset holding the reference dataset's live records
    under the same declarations (indexes are declared before the records
    arrive, so every flushed component carries its postings)."""
    policy = ref.merge_policy
    ds = PartitionedDataset(
        ref.name, adm_type_from_reference(ref.dtype), ref.pk,
        num_partitions=ref.num_partitions,
        flush_threshold=ref.flush_threshold,
        merge_policy=TieredMergePolicy(k=policy.k, ratio=policy.ratio),
        columnar=ref.columnar)
    ds.spatial_cell_size = ref.spatial_cell_size
    for fld in ref.index_fields:
        ds.create_index(fld, kind=ref.index_kinds.get(fld, "btree"),
                        gram_length=ref._ngram_specs.get(fld, 3))
    ds.insert_batch(ref.scan())
    return ds
