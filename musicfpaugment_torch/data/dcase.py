"""DCASE background-noise dataset metadata and scene splits (port of
musicfpaugment_tpu/data/dcase.py, the reference's
training/background_noise.py).

Unions the six DCASE datasets (2017/2018/2020 dev+eval, device-a filter for
2018/2020 dev), drops the "metro" scene, groups file paths per scene label,
and splits 20 val / 100 test / rest train per scene into
``training/splits/{train,val,test}.json`` — the files the reference gitignores
and regenerates.
"""

from __future__ import annotations

import json
import os
import random
from typing import Any, Dict, List, Tuple

import pandas as pd

from musicfpaugment_torch.train.parameters import (
    dcase_2017_dev_path,
    dcase_2017_eval_path,
    dcase_2018_dev_path,
    dcase_2018_eval_path,
    dcase_2020_dev_path,
    dcase_2020_eval_path,
)

SPLITS_DIR = os.environ.get(
    "MFPA_SPLITS_DIR", os.path.join(os.path.dirname(__file__), "splits")
)


def get_dcase2017(path: str) -> pd.DataFrame:
    """ref: background_noise.py:19-27."""
    data = pd.read_csv(
        os.path.join(path, "meta.txt"), sep="\t", header=None, engine="python"
    )
    return data.rename(columns={0: "filename", 1: "scene_label", 2: "location"})


def get_dcase2018_2020(path: str, type: str = "dev") -> pd.DataFrame:
    """ref: background_noise.py:30-48."""
    if type == "dev":
        data = pd.read_csv(
            os.path.join(path, "meta.csv"), sep=",|\t", header=0, engine="python"
        )
        data = data.rename(
            columns={"identifier": "location", "source_label": "device"}
        )
    else:
        if "2020" in path:
            data = pd.read_csv(
                os.path.join(path, "evaluation_setup/fold1_test.csv"),
                sep=",|\t",
                header=0,
                engine="python",
            )
        else:
            data = pd.read_csv(
                os.path.join(path, "evaluation_setup/test.txt"),
                sep=",|\t",
                header=None,
                engine="python",
            )
            data = data.rename(columns={0: "filename"})
    return data


class NoiseDataset:
    """Background-noise dataset wrapper (ref: background_noise.py:111-268)."""

    def __init__(self, name: str, type: str = "dev") -> None:
        self.name = name
        self.type = type
        if self.name == "dcase2017":
            self.path = dcase_2017_dev_path if type == "dev" else dcase_2017_eval_path
            self.dataset = get_dcase2017(self.path)
        if self.name == "dcase2018":
            self.path = dcase_2018_dev_path if type == "dev" else dcase_2018_eval_path
            self.dataset = get_dcase2018_2020(self.path, type=type)
        if self.name == "dcase2020":
            self.path = dcase_2020_dev_path if type == "dev" else dcase_2020_eval_path
            self.dataset = get_dcase2018_2020(self.path, type=type)
        if self.name == "union":
            self.path = "union"
            self.dataset = get_dcase_union()
        self.size = len(self.dataset)
        self.columns = self.dataset.columns

    def balance_dataset(self) -> None:
        g = self.dataset.groupby("scene_label")
        self.dataset = g.apply(
            lambda x: x.sample(g.size().min(), random_state=42)
        ).reset_index(drop=True)

    def drop(self, column: str, label: Any) -> None:
        self.dataset = self.dataset[self.dataset[column] != str(label)]

    def filter_dataset(self, conditions: List[Dict[str, Any]]) -> None:
        filtered = self.dataset
        for condition in conditions:
            col, op, val = condition["column"], condition["operator"], condition["value"]
            if op == "equals":
                filtered = filtered.loc[filtered[col] == val]
            elif op == "superior":
                filtered = filtered.loc[filtered[col] > val]
            elif op == "inferior":
                filtered = filtered.loc[filtered[col] < val]
        self.dataset = filtered

    def get_classes(self):
        self.classes = self.dataset.scene_label.unique()
        return self.classes

    def get_nb_samples_per_class(self):
        self.samples_per_class = (
            self.dataset.groupby("scene_label").count()["filename"].to_dict()
        )
        return self.samples_per_class

    def get_file_paths_per_class(self) -> Dict[str, List[str]]:
        self.dataset = self.dataset.dropna()
        file_paths: Dict[str, List[str]] = {}
        for _, row in self.dataset.iterrows():
            file_paths.setdefault(row["scene_label"], []).append(row["filename"])
        self.file_paths = file_paths
        return self.file_paths

    def train_val_test_split(
        self, num_val: int = 20, num_test: int = 100
    ) -> Tuple[Dict[str, List[str]], Dict[str, List[str]], Dict[str, List[str]]]:
        """20 val / 100 test / rest train per scene
        (ref: background_noise.py:240-257)."""
        train_paths, val_paths, test_paths = {}, {}, {}
        for scene_label, filenames in self.file_paths.items():
            random.shuffle(filenames)
            val_paths[scene_label] = filenames[:num_val]
            test_paths[scene_label] = filenames[num_val : num_test + num_val]
            train_paths[scene_label] = filenames[num_test + num_val :]
        return train_paths, val_paths, test_paths

    def sample_from_class(self, scene_label: str, n: int) -> List[Any]:
        files = list(
            self.dataset.loc[self.dataset["scene_label"] == str(scene_label)][
                "filename"
            ]
        )
        return random.sample(files, n)


def get_dcase_union() -> pd.DataFrame:
    """Union of the six DCASE datasets (ref: background_noise.py:51-108)."""
    device_a = [{"column": "device", "operator": "equals", "value": "a"}]

    parts = []
    for name, typ, root, filt in [
        ("dcase2017", "dev", dcase_2017_dev_path, None),
        ("dcase2017", "eval", dcase_2017_eval_path, None),
        ("dcase2018", "dev", dcase_2018_dev_path, device_a),
        ("dcase2018", "eval", dcase_2018_eval_path, None),
        ("dcase2020", "dev", dcase_2020_dev_path, device_a),
        ("dcase2020", "eval", dcase_2020_eval_path, None),
    ]:
        ds = NoiseDataset(name=name, type=typ)
        if filt:
            ds.filter_dataset(filt)
            ds.dataset.drop(columns=["device"], inplace=True)
        ds.dataset["filename"] = root + "/" + ds.dataset["filename"]
        parts.append(ds.dataset)
    return pd.concat(parts).reset_index().drop(columns=["index"])


def build_splits(splits_dir: str = SPLITS_DIR) -> None:
    """Write train/val/test scene-split jsons
    (ref: background_noise.py:271-284, with 'metro' dropped)."""
    noise_dataset = NoiseDataset("union")
    noise_dataset.drop("scene_label", "metro")
    noise_dataset.get_file_paths_per_class()
    train_paths, val_paths, test_paths = noise_dataset.train_val_test_split()
    os.makedirs(splits_dir, exist_ok=True)
    for name, paths in [
        ("train", train_paths),
        ("val", val_paths),
        ("test", test_paths),
    ]:
        with open(os.path.join(splits_dir, f"{name}.json"), "w") as json_file:
            json.dump(paths, json_file, indent=4)


def load_noise_split(split: str = "train") -> Dict[str, List[str]]:
    """Read a previously built scene split (ref: dataset.py:180-192)."""
    path = os.path.join(SPLITS_DIR, f"{split}.json")
    with open(path, "r") as f:
        return json.load(f)


if __name__ == "__main__":
    build_splits()
