"""FMA-large evaluation-corpus selection (port of
musicfpaugment_tpu/testing/fma_preprocessing.py, with ``csv`` and numpy in
place of pandas).

The selection defines the paper's 10k queries, so it equals the JAX
package's pandas selection element by element:

* FMA's ``tracks.csv`` has two header rows (the column's group and its
  name) and a third row naming the index (``track_id``); only the
  ``("track", "genre_top")`` and ``("track", "duration")`` columns are read,
  and pandas' default NA strings read as missing;
* tracks of 12 s or less are dropped (strict ``>``);
* genres go in ``value_counts()`` order: missing genres left out, counts
  descending, ties in order of first appearance (pandas sorts the counts
  with a stable sort);
* a genre of fewer than 900 tracks keeps all of them in table order, one of
  more than 900 keeps the 885 that ``DataFrame.sample(n=885,
  random_state=42)`` picks, which is the row order
  ``np.random.RandomState(42).choice(n, 885, replace=False)``; a genre of
  exactly 900 is dropped (both comparisons are strict);
* the list is shuffled by Python's ``random`` seeded 31, and six positions
  are popped from it in turn.

A table here is a dict of equal-length column lists (``file_paths``,
``top_genre`` with ``None`` for a missing genre, ``duration`` with NaN for a
missing one). ``MFPA_FMA_ROOT`` and ``MFPA_DATASET_DIR`` override the FMA
root and the dataset directory; they are read at each call.
"""

from __future__ import annotations

import csv
import glob
import math
import os
import random
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

DEFAULT_FMA_ROOT = "/workspace/fma"
DEFAULT_DATASET_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dataset")

MIN_DURATION_S = 12  # strict >: 12 s tracks are dropped
GENRE_CAP_THRESHOLD = 900  # strict on both sides: genres of exactly 900 are dropped
GENRE_SAMPLE_SIZE = 885
SHUFFLE_SEED = 31
GENRE_SAMPLE_SEED = 42
EXCEPTION_POSITIONS = (77, 2476, 2979, 3023, 4165, 7945)

# pandas' default NA strings (read_csv's na_values)
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
})

Table = Dict[str, list]
Number = Union[int, float]


def fma_root() -> str:
    return os.environ.get("MFPA_FMA_ROOT", DEFAULT_FMA_ROOT)


def dataset_dir() -> str:
    return os.environ.get("MFPA_DATASET_DIR", DEFAULT_DATASET_DIR)


def blacklist_paths() -> List[str]:
    """The 198 corrupt or duplicate files left out of the index
    (``dataset/fma_large_to_remove.txt``)."""
    path = os.path.join(dataset_dir(), "fma_large_to_remove.txt")
    if not os.path.exists(path):
        return []
    with open(path) as fh:
        return [os.path.join(fma_root(), line) for line in fh.read().splitlines() if line]


def preprocessing_fma_large() -> List[str]:
    """Every fma_large mp3 but the blacklisted ones."""
    candidates = glob.glob(os.path.join(fma_root(), "fma_large", "*", "*.mp3"))
    excluded = set(blacklist_paths())
    return [p for p in candidates if p not in excluded]


def track_id_to_path(track_id) -> str:
    """FMA shards its files by the first 3 digits of the zero-padded id."""
    tid = str(track_id).zfill(6)
    return f"{fma_root()}/fma_large/{tid[:3]}/{tid}.mp3"


get_file_path = track_id_to_path


def _number(token: str) -> Number:
    """A numeric cell as pandas infers it: an int literal stays an int,
    anything else a float, an NA string NaN."""
    if token in NA_VALUES:
        return math.nan
    try:
        return int(token)
    except ValueError:
        return float(token)


def _text(token: str) -> Optional[str]:
    return None if token in NA_VALUES else token


def _index_value(token: str):
    try:
        return int(token)
    except ValueError:
        return token


def read_track_metadata(tracks_csv: str) -> Table:
    """Columns (top_genre, duration, file_paths) of FMA's ``tracks.csv``,
    in file order."""
    with open(tracks_csv, newline="") as fh:
        rows = csv.reader(fh)
        groups, names = next(rows), next(rows)
        columns = list(zip(groups, names))
        genre_col = columns.index(("track", "genre_top"))
        duration_col = columns.index(("track", "duration"))
        out: Table = {"top_genre": [], "duration": [], "file_paths": []}
        for i, row in enumerate(rows):
            if i == 0 and not any(row[1:]):  # the index-name row
                continue
            out["top_genre"].append(_text(row[genre_col]))
            out["duration"].append(_number(row[duration_col]))
            out["file_paths"].append(track_id_to_path(_index_value(row[0])))
    return out


def read_table(path: str) -> Table:
    """A one-header-row csv, every column read as pandas would read
    ``fma_large_preprocessed.csv``: ``duration`` numeric, the rest text."""
    with open(path, newline="") as fh:
        rows = csv.reader(fh)
        header = next(rows)
        out: Table = {name: [] for name in header}
        for row in rows:
            if not row:  # pandas skips blank lines
                continue
            for name, token in zip(header, row):
                out[name].append(_number(token) if name == "duration" else _text(token))
    return out


def _format_column(values: list) -> List[str]:
    """Cells as ``DataFrame.to_csv`` writes them: an all-int column as
    ints, a numeric column with a float or a NaN as floats, NaN and None as
    empty cells."""
    numeric = [v for v in values if v is not None and not isinstance(v, str)]
    as_float = any(isinstance(v, float) for v in numeric)
    out = []
    for v in values:
        if v is None or (isinstance(v, float) and math.isnan(v)):
            out.append("")
        elif isinstance(v, str):
            out.append(v)
        else:
            out.append(repr(float(v)) if as_float else str(v))
    return out


def write_table(table: Table, path: str) -> None:
    names = list(table)
    cells = [_format_column(table[n]) for n in names]
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh, lineterminator="\n")
        w.writerow(names)
        w.writerows(zip(*cells))


def load(filepath: str) -> Table:
    """``tracks.csv`` as :func:`read_track_metadata`, a genres csv as a
    table of its columns."""
    name = os.path.basename(filepath)
    if "genres" in name:
        return read_table(filepath)
    if "tracks" in name:
        return read_track_metadata(filepath)
    raise ValueError(f"File {name} cannot be opened.")


def _take(table: Table, rows: Sequence[int]) -> Table:
    return {k: [v[i] for i in rows] for k, v in table.items()}


class TestSet:
    """Genre-balanced query selection over a table (see the module's
    docstring for the order it keeps)."""

    __test__ = False  # not a pytest class

    def __init__(self, dataset: Table) -> None:
        self.dataset = dataset

    def get_samples_per_class(self) -> Dict[Optional[str], int]:
        """Rows per genre, missing genres included (under ``None``)."""
        counts: Dict[Optional[str], int] = {}
        for g in self.dataset["top_genre"]:
            counts[g] = counts.get(g, 0) + 1
        return counts

    def remove_short_tracks(self) -> None:
        keep = [i for i, d in enumerate(self.dataset["duration"]) if d > MIN_DURATION_S]
        self.dataset = _take(self.dataset, keep)

    def _value_counts(self) -> List[tuple]:
        """(genre, count), as ``Series.value_counts()`` orders them."""
        counts: Dict[str, int] = {}
        for g in self.dataset["top_genre"]:
            if g is not None:
                counts[g] = counts.get(g, 0) + 1
        return sorted(counts.items(), key=lambda kv: -kv[1])  # stable: ties keep first appearance

    def _genre_paths(self, genre: str, count: int) -> List[str]:
        paths = [p for p, g in zip(self.dataset["file_paths"], self.dataset["top_genre"]) if g == genre]
        if count < GENRE_CAP_THRESHOLD:
            return paths
        if count > GENRE_CAP_THRESHOLD:
            rows = np.random.RandomState(GENRE_SAMPLE_SEED).choice(
                len(paths), size=GENRE_SAMPLE_SIZE, replace=False
            )
            return [paths[i] for i in rows]
        return []  # a genre of exactly 900: dropped

    def sample_queries(self) -> List[str]:
        random.seed(SHUFFLE_SEED)
        samples: List[str] = []
        for genre, count in self._value_counts():
            samples.extend(self._genre_paths(genre, count))
        random.shuffle(samples)
        return samples

    def remove_exceptions(self, samples: List[str]) -> List[str]:
        for position in EXCEPTION_POSITIONS:
            samples.pop(position)
        return samples


def read_path_list(path: str) -> List[str]:
    """The non-blank lines of a one-column, header-less path list."""
    with open(path) as fh:
        return [line.rstrip("\n") for line in fh if line.strip()]


def main() -> None:
    """Join each path of ``fma_large_preprocessed.txt`` (in the dataset
    directory) to its genre and duration from ``fma_metadata/tracks.csv``
    (a left join: a path with no metadata keeps empty cells) and write
    ``fma_large_preprocessed.csv``."""
    metadata = read_track_metadata(os.path.join(fma_root(), "fma_metadata", "tracks.csv"))
    rows_of: Dict[str, List[int]] = {}
    for i, p in enumerate(metadata["file_paths"]):
        rows_of.setdefault(p, []).append(i)
    joined: Table = {"file_paths": [], "top_genre": [], "duration": []}
    for p in read_path_list(os.path.join(dataset_dir(), "fma_large_preprocessed.txt")):
        for i in rows_of.get(p, [None]):
            joined["file_paths"].append(p)
            joined["top_genre"].append(None if i is None else metadata["top_genre"][i])
            joined["duration"].append(math.nan if i is None else metadata["duration"][i])
    write_table(joined, os.path.join(dataset_dir(), "fma_large_preprocessed.csv"))


def preprocessed_table() -> Table:
    """``fma_large_preprocessed.csv`` of the dataset directory."""
    return read_table(os.path.join(dataset_dir(), "fma_large_preprocessed.csv"))


if __name__ == "__main__":
    main()
