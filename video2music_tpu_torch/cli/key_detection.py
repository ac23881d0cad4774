"""CLI: key-signature detection from emotion features
(``python -m video2music_tpu.cli.key_detection``).

Rebuild of ``train_eval_key_detection.py`` (reference: :40-241): flattened
per-second emotion probabilities (300*6 = 1800-d) -> key_val class, trained
with the same sklearn classifier zoo, metrics written to
``key_detection_results.json`` and models saved with joblib.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def build_models():
    from sklearn.ensemble import (AdaBoostClassifier, BaggingClassifier,
                                  GradientBoostingClassifier,
                                  RandomForestClassifier)
    from sklearn.naive_bayes import GaussianNB
    from sklearn.neural_network import MLPClassifier
    from sklearn.svm import SVC
    from sklearn.tree import DecisionTreeClassifier

    # reference: train_eval_key_detection.py:147-170
    return {
        "SVC_linear": SVC(kernel="linear", probability=True),
        "SVC_poly": SVC(kernel="poly", probability=True),
        "SVC_rbf": SVC(kernel="rbf", probability=True),
        "DecisionTreeClassifier": DecisionTreeClassifier(),
        "RandomForestClassifier_50": RandomForestClassifier(
            n_estimators=50, max_depth=20, max_features="sqrt",
            min_samples_leaf=5, min_samples_split=10),
        "AdaBoostClassifier": AdaBoostClassifier(),
        "GradientBoostingClassifier": GradientBoostingClassifier(
            warm_start=True, min_samples_leaf=5, min_samples_split=10,
            max_features="sqrt"),
        "BaggingClassifier": BaggingClassifier(max_samples=5,
                                               max_features=5,
                                               warm_start=True),
        "MLPClassifier": MLPClassifier(hidden_layer_sizes=256,
                                       solver="adam",
                                       learning_rate="adaptive",
                                       max_iter=500),
        "GaussianNB": GaussianNB(),
    }


def dataset_to_xy(dataset):
    """Per-sample feature = emotion.flatten(), target = key_val
    (reference: train_eval_key_detection.py:40-45)."""
    X, y = [], []
    for i in range(len(dataset)):
        s = dataset[i]
        X.append(np.asarray(s["emotion"], np.float32).flatten())
        y.append(float(np.asarray(s["key_val"]).ravel()[0]))
    return np.asarray(X), np.asarray(y)


def run_key_detection(train_ds, val_ds, test_ds, model_dir, results_path,
                      models=None, log=print):
    from sklearn.metrics import accuracy_score, f1_score
    import joblib

    X_train, y_train = dataset_to_xy(train_ds)
    Xv, yv = dataset_to_xy(val_ds)
    X_train = np.concatenate([X_train, Xv])
    y_train = np.concatenate([y_train, yv])
    X_test, y_test = dataset_to_xy(test_ds)

    os.makedirs(model_dir, exist_ok=True)
    results = {}
    for name, model in (models or build_models()).items():
        log(f"training {name}...")
        model.fit(X_train, y_train)
        pred = model.predict(X_test)
        acc = accuracy_score(pred, y_test)
        f1 = f1_score(pred, y_test, average="weighted")
        results[name] = {"Acc": float(acc), "F1": float(f1)}
        log(f"  test acc={acc:.4f} f1={f1:.4f}")
        joblib.dump(model, os.path.join(model_dir, f"{name}.pkl"))
    with open(results_path, "w") as f:
        json.dump(results, f, indent=4)
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description="Key detection (sklearn zoo)")
    p.add_argument("-dataset_dir", default="./dataset")
    p.add_argument("-model_dir", default="saved_models/key_detection")
    p.add_argument("-results", default="key_detection_results.json")
    args = p.parse_args(argv)

    from ..data import create_vevo_datasets
    train_ds, val_ds, test_ds = create_vevo_datasets(
        dataset_root=args.dataset_dir)
    if not len(train_ds):
        raise SystemExit(f"no complete samples under {args.dataset_dir}")
    run_key_detection(train_ds, val_ds, test_ds, args.model_dir,
                      args.results)


if __name__ == "__main__":
    main()
