"""A DOUBLE-field dataset and its sum / avg / min / max plans, built the
same way in the reference and in the port (``pkg`` carries one package's
``adm``, ``dsm`` and ``A`` modules): shared by the CPU slice test against
the reference and the card test against the CPU port."""

import numpy as np


def double_dataset(pkg, n, parts):
    """``n`` records with a DOUBLE field of standard normals x 1e3 (seeded
    numpy), flushed into components, with a B+-tree index on it."""
    rtype = pkg.adm.RecordType("F", (pkg.adm.Field("id", pkg.adm.INT64),
                                     pkg.adm.Field("v", pkg.adm.DOUBLE)),
                               open=False)
    ds = pkg.dsm.PartitionedDataset("F", rtype, "id", num_partitions=parts,
                                    flush_threshold=1 << 20)
    vals = np.random.default_rng(n).standard_normal(n) * 1e3
    ds.insert_batch([{"id": i, "v": float(v)} for i, v in enumerate(vals)])
    for part in ds.partitions:
        part.primary.flush()
    ds.create_index("v")
    return {"F": ds}


def double_plans(A):
    """sum, avg, min and max of the DOUBLE field over a full scan, an
    exact skip-index range (the fused K2 pass) and an index range whose
    survivors are re-checked and aggregated as a gathered batch."""
    aggs = {"s": ("sum", "v"), "a": ("avg", "v"), "mn": ("min", "v"),
            "mx": ("max", "v"), "c": ("count", "*")}

    def sel(**kw):
        return A.select(A.scan("F"), pred=lambda r: r["v"] >= -2000.0,
                        fields=["v"], ranges={"v": (-2000.0, None)}, **kw)
    return {"scan": A.aggregate(A.scan("F"), aggs),
            "exact_range": A.aggregate(
                sel(ranges_exact=True, hints=["skip-index"]), aggs),
            "index_range": A.aggregate(sel(), aggs)}


DOUBLE_SIZES = [(1000, 1), (6000, 4), (65536, 1)]
