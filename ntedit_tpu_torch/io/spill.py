"""Per-contig record spill: crash-safe resume at contig granularity.

A copy of the JAX package's spill (the port keeps its own host code).  The
reference's engine stage is all-or-nothing: an interrupted ``ntedit``
restarts from zero.  Here each polished contig's three rendered output
fragments (fa / changes.tsv / variants.vcf) are spilled to a prefix-keyed
directory as soon as the contig completes, and a re-run skips every contig
whose spill record matches, producing output byte-identical to an
uninterrupted run (tests/test_torch_spill.py).

A spill record is only trusted when its identity line matches the contig
(index, header, length, CRC32) AND the run manifest matches (draft and
filter file identity, every engine parameter): any drift clears the spill.
Records are written atomically (tmp + rename), so a kill mid-write never
corrupts the log.  The directory is removed after the final outputs are
written (set NTEDIT_TPU_KEEP_SPILL=1 to keep it).
"""

from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Optional, Tuple

MANIFEST = "manifest.json"


class ContigSpill:
    def __init__(self, prefix: str, manifest: dict):
        self.dir = prefix + "_spill"
        self.manifest = dict(manifest)
        os.makedirs(self.dir, exist_ok=True)
        mpath = os.path.join(self.dir, MANIFEST)
        existing = None
        if os.path.exists(mpath):
            try:
                with open(mpath) as f:
                    existing = json.load(f)
            except (OSError, ValueError):
                existing = None
        if existing != self.manifest:
            # parameter or input drift: stale records must not resume
            for name in os.listdir(self.dir):
                if name.endswith(".rec") or name == MANIFEST:
                    os.unlink(os.path.join(self.dir, name))
            tmp = mpath + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self.manifest, f)
            os.replace(tmp, mpath)

    @staticmethod
    def crc(seq) -> int:
        return zlib.crc32(memoryview(seq))

    def _path(self, idx: int) -> str:
        return os.path.join(self.dir, f"{idx:08d}.rec")

    def get(self, idx: int, header: str, length: int,
            crc: int) -> Optional[Tuple[str, str, str]]:
        """The contig's rendered (fa, tsv, vcf) fragments, or None when no
        matching record exists."""
        path = self._path(idx)
        if not os.path.exists(path):
            return None
        try:
            with open(path, "rb") as f:
                meta = json.loads(f.readline())
                if (meta["header"] != header or meta["length"] != length
                        or meta["crc"] != crc):
                    return None
                blobs = [f.read(n) for n in meta["sizes"]]
        except (OSError, ValueError, KeyError):
            return None
        if [len(b) for b in blobs] != meta["sizes"]:
            return None  # truncated
        return tuple(b.decode() for b in blobs)

    def put(self, idx: int, header: str, length: int, crc: int,
            fa: str, tsv: str, vcf: str) -> None:
        path = self._path(idx)
        blobs = [fa.encode(), tsv.encode(), vcf.encode()]
        meta = {"header": header, "length": length, "crc": crc,
                "sizes": [len(b) for b in blobs]}
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(json.dumps(meta).encode() + b"\n")
            for b in blobs:
                f.write(b)
        os.replace(tmp, path)

    def finalize(self) -> None:
        """Remove the spill after the final outputs are safely written."""
        if os.environ.get("NTEDIT_TPU_KEEP_SPILL") == "1":
            return
        shutil.rmtree(self.dir, ignore_errors=True)
