"""SiLU exponential-approximation experiment
(``python -m video2music_tpu.cli.silu_approx``).

Port of the reference's standalone curve-fitting script (reference:
``script/sigmoid_approximately.py:1-54``): fit

    silu(x) = x * sigmoid(x)  ~=  0.5 * x * (e*exp(a*x + b) + f*exp(c*x + d))

over x in [-5, 4] with Powell minimization, print the coefficients and
(optionally) save a comparison plot. Kept faithful to the original,
including its quirk of fitting with ``+`` between the exponential terms but
PLOTTING with ``-`` (reference :14 vs :47) — the plot branch reproduces
that sign unless ``--fixed-sign`` is passed.
"""

from __future__ import annotations

import argparse

import numpy as np


def sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def silu(x):
    return x * sigmoid(x)


def approx(params, x, plot_sign: float = 1.0):
    a, b, c, d, e, f = params
    return 0.5 * x * (e * np.exp(a * x + b)
                      + plot_sign * f * np.exp(c * x + d))


def objective(params, x):
    return float(np.sum((silu(x) - approx(params, x)) ** 2))


def fit_silu_approximation(x=None):
    """Powell fit of the 6-parameter exponential SiLU approximation
    (reference :17-29). Returns (a, b, c, d, e, f)."""
    from scipy.optimize import minimize

    if x is None:
        x = np.linspace(-5, 4, 100)
    initial = [0.1, 0.1, 0.1, 0.1, 0.8, 0.2]
    result = minimize(objective, initial, args=(x,), method="Powell")
    if not result.success:
        raise ValueError("Optimization failed.")
    return tuple(result.x)


def main(argv=None):
    p = argparse.ArgumentParser(description="Fit exp-approximation of SiLU")
    p.add_argument("--plot", default=None,
                   help="save a comparison plot to this path")
    p.add_argument("--fixed-sign", action="store_true",
                   help="plot with the FITTED '+' sign instead of the "
                        "reference's '-' plotting quirk")
    args = p.parse_args(argv)

    params = fit_silu_approximation()
    names = "abcdef"
    for n, v in zip(names, params):
        print(f"{n} = {v:.6f}")
    x = np.linspace(-5, 4, 200)
    err = float(np.max(np.abs(silu(x) - approx(params, x))))
    print(f"max |silu - approx| on [-5, 4]: {err:.4f}")

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        xs = np.linspace(-10, 10, 100)
        sign = 1.0 if args.fixed_sign else -1.0
        plt.figure(figsize=(8, 6))
        plt.plot(xs, silu(xs), label="SiLU", color="blue")
        plt.plot(xs, approx(params, xs, plot_sign=sign),
                 label="Approximate SiLU", color="red", linestyle="dashed")
        plt.xlabel("x")
        plt.ylabel("y")
        plt.legend()
        plt.grid(True)
        plt.savefig(args.plot, dpi=100)
        print("wrote", args.plot)


if __name__ == "__main__":
    main()
