"""Style-embedding analytics (port of osu_diffusion_tpu/evals/embeddings.py):
t-SNE projection, SVM tag/mapper classification, nearest/furthest-neighbour
queries, checkpoint introspection.

Ports of reference testing/plot_embeddings.py, embedding_svm.py,
find_similar_beatmaps.py, find_unique_beatmaps.py and print_ckpt.py, as
functions with explicit inputs (the reference scripts hardcode Windows paths)
plus CLI subcommands. Reads `.pt` checkpoints (the reference's and the port
trainer's, by torch's weights-only unpickler); an orbax directory of the JAX
package is refused, since reading one needs JAX. scipy, sklearn, pandas and
matplotlib are imported inside the functions that use them.
"""
from __future__ import annotations

import os
import pickle

import numpy as np


def _load_pt(ckpt_path: str) -> dict:
    """The whole dict of a `.pt` checkpoint; an orbax directory is refused."""
    if os.path.isdir(ckpt_path):
        raise ValueError(
            f"{ckpt_path} is a directory (an orbax checkpoint of the JAX package): the port "
            "reads .pt files only; export it to the torch layout with the JAX package's "
            "train/checkpoint.py save_torch_compatible first")
    from osu_diffusion_tpu_torch.train.checkpoint import load_train_checkpoint

    return load_train_checkpoint(ckpt_path)


def load_embedding_table(ckpt_path: str) -> np.ndarray:
    """(num_classes+1, hidden) style table of a `.pt` checkpoint: the EMA
    weights' where the file has them."""
    ckpt = _load_pt(ckpt_path)
    if "ema" in ckpt:
        ckpt = ckpt["ema"]
    return ckpt["y_embedder.embedding_table.weight"].numpy()


def tsne_embeddings(
    embedding_table: np.ndarray,
    num_classes: int = 52670,
    cache_file: str | None = None,
    random_state: int = 1,
    n_iter: int = 1000,
) -> np.ndarray:
    """2-D t-SNE of the style table, cosine metric, cached to .npy.
    Parity: plot_embeddings.py:186-196."""
    if cache_file is not None and os.path.isfile(cache_file):
        return np.load(cache_file)
    from sklearn.manifold import TSNE

    tsne = TSNE(random_state=random_state, max_iter=n_iter, metric="cosine")
    embs = tsne.fit_transform(embedding_table)[:num_classes]
    if cache_file is not None:
        np.save(cache_file, embs)
    return embs


def fit_tag_svm(
    embedding_table: np.ndarray,
    groups: list[np.ndarray],
):
    """Linear SVM over style embeddings; groups = per-class index arrays.
    Parity: embedding_svm.py:62-75. Returns the fitted classifier."""
    from sklearn import svm

    xs = [embedding_table[idx] for idx in groups]
    ys = [np.full(len(idx), k) for k, idx in enumerate(groups)]
    # deliberate deviation: the reference passes probability=True
    # (embedding_svm.py:74) but its only predict_proba use is commented out
    # (:110) — only .predict is called. Dropping it avoids the sklearn>=1.9
    # FutureWarning and the 5-fold Platt-calibration fit cost.
    clf = svm.SVC(kernel="linear")
    clf.fit(np.concatenate(xs), np.concatenate(ys))
    return clf


def svm_accuracy(clf, embedding_table: np.ndarray, indices: np.ndarray, label: int) -> float:
    from sklearn import metrics

    pred = clf.predict(embedding_table[indices])
    return float(metrics.accuracy_score(np.full(len(indices), label), pred))


def find_similar(
    embedding_table: np.ndarray,
    beatmap_idx: dict[int, int],
    beatmap_id: int,
    k: int = 10,
    metric: str = "euclidean",
) -> list[tuple[int, float]]:
    """k most-distant (parity quirk: the reference's argpartition(-k) picks the
    LARGEST distances, find_similar_beatmaps.py:27-33) beatmaps by embedding
    distance. Returns [(beatmap_id, distance)]."""
    import scipy.spatial.distance

    idx_beatmap = {v: kk for kk, v in beatmap_idx.items()}
    query = embedding_table[beatmap_idx[beatmap_id]]
    dist = scipy.spatial.distance.cdist(
        embedding_table, query[None], metric=metric
    )[:, 0]
    picked = np.argpartition(dist, -k)[-k:]
    out = []
    for x in picked:
        if int(x) in idx_beatmap:
            out.append((idx_beatmap[int(x)], float(dist[x])))
    return out


def find_nearest(
    embedding_table: np.ndarray,
    beatmap_idx: dict[int, int],
    beatmap_id: int,
    k: int = 10,
    metric: str = "cosine",
) -> list[tuple[int, float]]:
    """k nearest beatmaps by embedding distance (the query the reference's
    script name promises; kept alongside the parity variant above)."""
    import scipy.spatial.distance

    idx_beatmap = {v: kk for kk, v in beatmap_idx.items()}
    query = embedding_table[beatmap_idx[beatmap_id]]
    dist = scipy.spatial.distance.cdist(
        embedding_table, query[None], metric=metric
    )[:, 0]
    picked = np.argsort(dist)[: k + 1]
    out = []
    for x in picked:
        if int(x) in idx_beatmap and int(x) != beatmap_idx[beatmap_id]:
            out.append((idx_beatmap[int(x)], float(dist[x])))
    return out[:k]


def mean_distance_to_group(
    embedding_table: np.ndarray, group_indices: np.ndarray
) -> np.ndarray:
    """Per-beatmap mean distance to a group (find_unique_beatmaps.py:29-31)."""
    import scipy.spatial.distance

    return np.mean(
        scipy.spatial.distance.cdist(embedding_table, embedding_table[group_indices]),
        axis=1,
    )


def group_uniqueness(
    embedding_table: np.ndarray, group_indices: np.ndarray
) -> np.ndarray:
    """Per-GROUP-MEMBER mean distance to the whole table — the reference's
    axis-0 mean (find_unique_beatmaps.py:30: np.mean(cdist(table, query), 0)).
    The members with the largest values are the mapper's most unusual maps."""
    import scipy.spatial.distance

    return np.mean(
        scipy.spatial.distance.cdist(embedding_table[group_indices], embedding_table),
        axis=1,
    )


# -- dataframe-backed group selection (reference beatmap_df.pkl + omdb tags) --


def load_tagged_dataframe(beatmap_df_path: str, tags_csv: str | None = None):
    """beatmap_df.pkl (evals/tooling.py `dataframe` layout, same columns as
    reference create_beatmap_dataframe.py), optionally left-merged with the
    omdb tag CSV exactly as embedding_svm.py:64-66 does: csv rows are
    (BeatmapID, tag), aggregated to a list per beatmap in column "omdb"."""
    import pandas as pd

    df = pd.read_pickle(beatmap_df_path)
    if tags_csv is not None:
        tags_df = (
            pd.read_csv(tags_csv, names=["BeatmapID", "omdb"])
            .groupby(["BeatmapID"])
            .agg(list)
        )
        df = pd.merge(df, tags_df, on="BeatmapID", how="left")
    return df


def maps_by_mapper(df, mapper: str):
    """Rows mapped by `mapper`: their own uploads plus guest difficulties
    naming them, minus other mappers' possessive difficulties. Parity with the
    regex filter of find_unique_beatmaps.py:7-13 / embedding_svm.py:7-9 (the
    two reference scripts target different dataframe vintages — Creator/
    Version vs Source/Difficulty; this dataframe's difficulty-name column is
    "Difficulty")."""
    import re

    # deliberate deviation: the reference interpolates the raw name into its
    # regexes, so mappers with metacharacters (e.g. "[Toy]", common in osu
    # usernames) select wrong groups or crash; escape the name instead
    name = re.escape(mapper)
    # non-capturing groups: capturing groups in str.contains emit a pandas
    # UserWarning ("match groups"); grouping is only for alternation here
    regex = (
        f"(?!\\s?(?:de\\s)?(?:it|that|{name}))"
        "(?:(?:(?:^|[^\\S\r\n])\\S*(?:[sz]'|'s))|(?:(?:^|[^\\S\r\n])de\\s\\S*))"
    )
    return df[
        ((df["Creator"] == mapper) | df["Difficulty"].str.contains(name))
        & ~df["Difficulty"].str.contains(regex)
    ]


def maps_by_tag(df, tag: str):
    """Rows whose omdb tag list contains `tag` (embedding_svm.py:12-13)."""
    return df[df["omdb"].apply(lambda x: isinstance(x, list) and tag in x)]


def print_ckpt(obj, indent: int = 0):
    """Recursive checkpoint structure dump. Parity: print_ckpt.py:4-16."""
    pad = "  " * indent
    if isinstance(obj, dict):
        for k, v in obj.items():
            if isinstance(v, (dict, list)):
                print(f"{pad}{k} \t state dict:")
                print_ckpt(v, indent + 1)
            elif hasattr(v, "shape"):
                print(f"{pad}{k} \t {tuple(v.shape)}")
            else:
                print(f"{pad}{k} \t {v}")
    elif isinstance(obj, list):
        for v in obj:
            print_ckpt(v, indent + 1)


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_tsne = sub.add_parser("tsne", help="2-D t-SNE projection of the style table")
    p_tsne.add_argument("--ckpt", required=True)
    p_tsne.add_argument("--num-classes", type=int, default=52670)
    p_tsne.add_argument("--cache-file", default="2d-embs.npy")
    p_tsne.add_argument("--plot", action="store_true")

    p_sim = sub.add_parser("similar", help="nearest/furthest beatmaps by style")
    p_sim.add_argument("--ckpt", required=True)
    p_sim.add_argument("--beatmap-idx", default=os.path.join("assets", "beatmap_idx.pickle"))
    p_sim.add_argument("--beatmap-id", type=int, required=True)
    p_sim.add_argument("-k", type=int, default=10)
    p_sim.add_argument("--nearest", action="store_true",
                       help="true nearest neighbours instead of the reference's "
                            "largest-distance parity behavior")

    p_print = sub.add_parser("print", help="dump checkpoint structure")
    p_print.add_argument("--ckpt", required=True)

    p_svm = sub.add_parser(
        "svm", help="linear-SVM style classification over tag or mapper groups"
    )
    p_svm.add_argument("--ckpt", required=True)
    p_svm.add_argument("--beatmap-df", required=True,
                       help="beatmap_df.pkl (evals/tooling.py `dataframe`)")
    p_svm.add_argument("--tags-csv", default=None,
                       help="omdb tag CSV: rows of (BeatmapID, tag)")
    group = p_svm.add_mutually_exclusive_group(required=True)
    group.add_argument("--tags", nargs="+",
                       help="train one class per omdb tag (needs --tags-csv)")
    group.add_argument("--mappers", nargs="+",
                       help="train one class per mapper name")
    p_svm.add_argument("--test-tags", nargs="*", default=[],
                       help="report per-class accuracy on these tag groups")
    p_svm.add_argument("--test-mappers", nargs="*", default=[],
                       help="report per-class accuracy on these mappers' maps")

    p_uniq = sub.add_parser(
        "unique", help="a mapper's most unusual maps by mean embedding distance"
    )
    p_uniq.add_argument("--ckpt", required=True)
    p_uniq.add_argument("--beatmap-df", required=True)
    p_uniq.add_argument("--mapper", required=True)
    p_uniq.add_argument("-k", type=int, default=10)

    args = parser.parse_args(argv)

    if args.cmd == "tsne":
        table = load_embedding_table(args.ckpt)
        embs = tsne_embeddings(table, args.num_classes, args.cache_file)
        print(f"t-SNE embeddings: {embs.shape} (cached at {args.cache_file})")
        if args.plot:
            import matplotlib.pyplot as plt

            plt.figure(figsize=(13, 9))
            plt.scatter(embs[:, 0], embs[:, 1], alpha=0.01)
            plt.show()
    elif args.cmd == "similar":
        table = load_embedding_table(args.ckpt)
        with open(args.beatmap_idx, "rb") as f:
            beatmap_idx = pickle.load(f)
        fn = find_nearest if args.nearest else find_similar
        for bid, dist in fn(table, beatmap_idx, args.beatmap_id, args.k):
            print(bid, dist)
    elif args.cmd == "svm":
        # Parity: embedding_svm.py:70-107 (get_tags_data/get_mappers_data,
        # clf.fit, test_positive[_tag] accuracy lines).
        table = load_embedding_table(args.ckpt)
        df = load_tagged_dataframe(args.beatmap_df, args.tags_csv)
        names = args.tags or args.mappers
        select = maps_by_tag if args.tags else maps_by_mapper
        if (args.tags or args.test_tags) and args.tags_csv is None:
            parser.error("--tags/--test-tags require --tags-csv")
        groups = [np.asarray(select(df, name).index) for name in names]
        counts = {k: len(g) for k, g in enumerate(groups)}
        print(counts)  # class-count line, parity embedding_svm.py:20,27
        clf = fit_tag_svm(table, groups)
        tests = [(t, maps_by_tag) for t in (args.test_tags or [])] + [
            (m, maps_by_mapper) for m in (args.test_mappers or [])
        ]
        if not tests:  # default: score the training groups themselves
            tests = [(n, select) for n in names]
        for test_name, test_select in tests:
            idx = np.asarray(test_select(df, test_name).index)
            scores = [
                f"{svm_accuracy(clf, table, idx, clas) * 100:.0f}% {tag}"
                for clas, tag in enumerate(names)
            ]
            print(f"{test_name} is {', '.join(scores)}")
    elif args.cmd == "unique":
        # Parity: find_unique_beatmaps.py:25-40.
        table = load_embedding_table(args.ckpt)
        df = load_tagged_dataframe(args.beatmap_df)
        maps = maps_by_mapper(df, args.mapper)
        print(f"Found {len(maps)} beatmaps.")
        dist = group_uniqueness(table, np.asarray(maps.index))
        k = min(args.k, len(dist))
        for x in np.argpartition(dist, -k)[-k:]:
            print(
                dist[x],
                f"{maps.iloc[x]['Title']} [{maps.iloc[x]['Difficulty']}]",
                maps.iloc[x]["BeatmapID"],
            )
    elif args.cmd == "print":
        print("Model's state_dict:")
        print_ckpt(_load_pt(args.ckpt))

if __name__ == "__main__":
    main()
