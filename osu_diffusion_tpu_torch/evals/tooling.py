"""Dataset metadata tooling over Mapperator-format datasets (port of
osu_diffusion_tpu/evals/tooling.py; pandas is imported by the dataframe
functions only).

Ports of reference testing/create_beatmap_idx.py (beatmap_id -> class index
pickle), create_beatmap_dataframe.py (metadata dataframe) and
validate_beatmap_dataframe.py (duplicate-ID check), with the dataset path as an
argument instead of a hardcoded Windows path.
"""
from __future__ import annotations

import json
import os
import pickle


def build_beatmap_idx(dataset_path: str, num_tracks: int = 13402) -> dict[int, int]:
    """beatmap_id -> dense class index, walking TrackNNNNN/metadata.json.
    Parity: create_beatmap_idx.py:1-22 (incl. the NNNNNN M NNN naming scheme)."""
    beatmap_idx: dict[int, int] = {}
    idx = 0
    for i in range(num_tracks):
        track_name = "Track" + str(i).zfill(5)
        metadata_file = os.path.join(dataset_path, track_name, "metadata.json")
        if not os.path.isfile(metadata_file):
            continue
        with open(metadata_file) as f:
            metadata = json.load(f)
        for j in range(len(metadata["Beatmaps"])):
            beatmap_name = str(idx).zfill(6) + "M" + str(j).zfill(3)
            beatmap_metadata = metadata["Beatmaps"][beatmap_name]
            beatmap_idx[beatmap_metadata["BeatmapId"]] = idx
            idx += 1
    return beatmap_idx


_DF_COLUMNS = [
    "BeatmapID", "BeatmapSetID", "TrackIndex", "SetIndex", "TrackName",
    "BeatmapName", "Artist", "Title", "Creator", "Source", "Tags", "Ruleset",
    "MD5Hash", "Difficulty", "OnlineOffset", "DrainTime", "TotalTime",
    "RankedStatus", "CirclesCount", "SpinnersCount", "SlidersCount",
    "CircleSize", "ApproachRate", "OverallDifficulty", "HPDrainRate",
    "SliderVelocity", "StackLeniency", "StarRating",
]


def build_beatmap_dataframe(dataset_path: str, num_tracks: int = 13402):
    """Metadata dataframe. Parity: create_beatmap_dataframe.py (same columns)."""
    import pandas as pd

    rows = []
    idx = 0
    for i in range(num_tracks):
        track_name = "Track" + str(i).zfill(5)
        metadata_file = os.path.join(dataset_path, track_name, "metadata.json")
        if not os.path.isfile(metadata_file):
            continue
        with open(metadata_file) as f:
            metadata = json.load(f)
        for j in range(len(metadata["Beatmaps"])):
            beatmap_name = str(idx).zfill(6) + "M" + str(j).zfill(3)
            bm = metadata["Beatmaps"][beatmap_name]
            rows.append([
                bm["BeatmapId"], metadata["BeatmapSetId"], i, j, track_name,
                beatmap_name, metadata["Artist"], metadata["Title"],
                metadata["Creator"], metadata["Source"], metadata["Tags"],
                bm["Ruleset"], bm["MD5Hash"], bm["Difficulty"],
                bm["OnlineOffset"], bm["DrainTime"], bm["TotalTime"],
                bm["RankedStatus"], bm["CirclesCount"], bm["SpinnersCount"],
                bm["SlidersCount"], bm["CircleSize"], bm["ApproachRate"],
                bm["OverallDifficulty"], bm["HPDrain"], bm["SliderVelocity"],
                bm["StackLeniency"], bm["StandardStarRating"]["0"],
            ])
            idx += 1
    return pd.DataFrame(rows, columns=_DF_COLUMNS)


def validate_beatmap_dataframe(df) -> dict:
    """Duplicate-beatmap-ID check. Parity: validate_beatmap_dataframe.py."""
    unique = int(df["BeatmapID"].nunique())
    id_counts = df["BeatmapID"].value_counts()
    duplicated = id_counts[id_counts > 1]
    return {
        "unique_ids": unique,
        "duplicates": df[df["BeatmapID"].isin(duplicated.index)],
    }


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_idx = sub.add_parser("idx", help="build beatmap_idx.pickle")
    p_idx.add_argument("--dataset-path", required=True)
    p_idx.add_argument("--num-tracks", type=int, default=13402)
    p_idx.add_argument("--out", default="beatmap_idx.pickle")

    p_df = sub.add_parser("dataframe", help="build beatmap_df.pkl")
    p_df.add_argument("--dataset-path", required=True)
    p_df.add_argument("--num-tracks", type=int, default=13402)
    p_df.add_argument("--out", default="beatmap_df.pkl")

    p_val = sub.add_parser("validate", help="duplicate-ID check")
    p_val.add_argument("--dataframe", default="beatmap_df.pkl")

    args = parser.parse_args(argv)

    if args.cmd == "idx":
        idx = build_beatmap_idx(args.dataset_path, args.num_tracks)
        with open(args.out, "wb") as f:
            pickle.dump(idx, f)
        print(f"wrote {len(idx)} entries to {args.out}")
    elif args.cmd == "dataframe":
        df = build_beatmap_dataframe(args.dataset_path, args.num_tracks)
        df.to_pickle(args.out)
        print(df.head())
        print(f"wrote {len(df)} rows to {args.out}")
    elif args.cmd == "validate":
        import pandas as pd

        res = validate_beatmap_dataframe(pd.read_pickle(args.dataframe))
        print(f"Number of unique beatmap IDs = {res['unique_ids']}")
        print("Duplicates:")
        print(res["duplicates"])


if __name__ == "__main__":
    main()
