"""RD-curve plotting CLI (reference: compressai/utils/plot/__main__.py).

Counterpart of lmic_tpu/utils/plot_cli.py, pure Python: reads eval-JSON
files (the format written by lmic_tpu_torch.utils.eval_model, the
video-bench list layout, or reference CompressAI results files with
per-quality arrays) and renders rate-distortion curves with matplotlib
(default) or plotly (--backend plotly -> interactive HTML, reference
__main__.py:120-142). Both are imported only when a plot is drawn.

Usage:
  lmic-torch-plot -f results/*.json --metric psnr -o rd_curve.png
"""

from __future__ import annotations

import argparse
import json
import math
import sys


def load_series(path: str, metric: str, rate_key: str = "bpp"):
    with open(path) as f:
        data = json.load(f)
    entries = data if isinstance(data, list) else [data]
    series = []
    for e in entries:
        res = e.get("results", e)
        if isinstance(res, list):
            # video-bench layout: list of per-quality dicts
            rate = [r.get(rate_key) for r in res]
            val = [r.get(metric, r.get(metric.replace("_", "-")))
                   for r in res]
        else:
            rate = res.get(rate_key)
            val = res.get(metric) or res.get(metric.replace("_", "-"))
        name = e.get("name", path)
        if rate is None or val is None or None in (
            rate if isinstance(rate, list) else [rate]
        ):
            continue
        if not isinstance(rate, list):
            rate, val = [rate], [val]
        pairs = sorted(zip(rate, val))
        series.append((name, [p[0] for p in pairs], [p[1] for p in pairs]))
    # merge entries sharing a name: lmic-eval appends one summary per run
    # (per quality), so a multi-quality file is N single-point entries of
    # the same arch — draw them as ONE rate-sorted RD curve, not N dots
    merged, order = {}, []
    for name, rate, val in series:
        if name not in merged:
            merged[name] = ([], [])
            order.append(name)
        merged[name][0].extend(rate)
        merged[name][1].extend(val)
    out = []
    for name in order:
        pairs = sorted(zip(*merged[name]))
        out.append((name, [p[0] for p in pairs], [p[1] for p in pairs]))
    return out


def render_plotly(series_list, ylabel, xlabel, title, output):
    """Plotly backend (reference utils/plot/__main__.py:120-142): build a
    go.Figure of scatters and write standalone HTML."""
    try:
        import plotly.graph_objs as go
        import plotly.io as pio
    except ImportError:
        # same actionable failure as the reference (:126-129)
        raise SystemExit(
            "Unable to import plotly, install with: pip install pandas "
            "plotly"
        )
    fig = go.Figure()
    for name, rate, val in series_list:
        fig.add_traces(go.Scatter(x=rate, y=val, name=name))
    fig.update_xaxes(title_text=xlabel)
    fig.update_yaxes(title_text=ylabel)
    if title:
        fig.update_layout(title=title)
    filename = output or "plot.html"
    pio.write_html(fig, file=filename, auto_open=False)
    print(f"saved {filename}")


def main(argv=None):
    p = argparse.ArgumentParser(description="RD curve plotting")
    p.add_argument("-f", "--results-file", nargs="+", required=True)
    p.add_argument("--metric", default="psnr",
                   choices=["psnr", "ms-ssim", "ms_ssim", "psnr-rgb",
                            "psnr-yuv", "psnr-y"])
    p.add_argument("-t", "--title", default="RD curves")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--rate", default="bpp", choices=["bpp", "bitrate"],
                   help="x axis: bpp (image) or bitrate kbps (video, "
                        "reference utils/video/plot)")
    p.add_argument("--ssim-db", action="store_true",
                   help="plot MS-SSIM as -10*log10(1 - v) dB")
    p.add_argument("--backend", choices=["matplotlib", "plotly"],
                   default="matplotlib",
                   help="matplotlib renders an image; plotly writes "
                        "interactive HTML (reference plot CLI parity)")
    args = p.parse_args(argv if argv is not None else sys.argv[1:])

    series_list = []
    for path in args.results_file:
        for name, rate, val in load_series(path, args.metric, args.rate):
            if args.ssim_db and "ssim" in args.metric:
                val = [-10 * math.log10(max(1e-12, 1 - v)) for v in val]
            series_list.append((name, rate, val))

    xlabel = "Bit-rate [bpp]" if args.rate == "bpp" else "Bit-rate [kbps]"
    if "psnr" in args.metric:
        ylabel = "PSNR [dB]"
    elif args.ssim_db:
        ylabel = "MS-SSIM [dB]"
    else:
        ylabel = "MS-SSIM"

    if args.backend == "plotly":
        render_plotly(series_list, ylabel, xlabel, args.title, args.output)
        return 0

    import matplotlib

    if args.output:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(9, 6))
    for name, rate, val in series_list:
        ax.plot(rate, val, ".-", label=name)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(args.title)
    ax.grid(True, alpha=0.3)
    ax.legend(loc="lower right")
    if args.output:
        fig.savefig(args.output, dpi=150, bbox_inches="tight")
        print(f"saved {args.output}")
    else:
        plt.show()
    return 0


if __name__ == "__main__":
    sys.exit(main())
