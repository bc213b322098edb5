"""The metric arithmetic: the window's rates over whole requests, the idle
union of a trace, the gaps named by host spans, and the FLOP counts of
the reference's shapes against the meta-device figures of SD-1.4 GLIGEN
(2 FLOPs a multiply-add): 1,134.0 GFLOP a row of a box+text UNet call
with the fusers, 803.3 without, 1,153.0 with hed's, 2,514.5 an image's
VAE decode."""

import json

import pytest

from benchmark import harness, trace
from benchmark.work import flops


def cfg(name):
    bench = harness.load_benchmark()
    return harness.config(bench, name)


def reqs(times, images=8, profiled=()):
    return [{"start": a, "end": b, "images": images, "ok": True, "profiled": i in profiled}
            for i, (a, b) in enumerate(times)]


def test_generation_rate_is_whole_requests_over_the_window():
    read = harness.reader("gen_img_per_s")
    rec = {"kind": "gen", "requests": reqs([(0, 2.5), (2.5, 5.0), (5.0, 7.6)]), "window_s": 7.6}
    assert read(rec) == pytest.approx(24 / 7.6)
    rec["requests"][1]["ok"] = False
    assert read(rec) == pytest.approx(16 / 7.6)
    assert read({"kind": "train"}) is None


def test_training_rate_and_peak():
    rec = {"kind": "train", "requests": reqs([(0, 1.0), (1.0, 2.5)], images=32), "window_s": 2.5,
           "memory_peak_bytes": 3 * 2**30}
    assert harness.reader("train_img_per_s")(rec) == pytest.approx(64 / 2.5)
    assert harness.reader("peak_mem_gib.train")(rec) == pytest.approx(3.0)


def test_idle_union_and_named_gaps():
    base_ns = 1_000_000_000_000
    ev = lambda ts, dur, name="k": {"ph": "X", "cat": "kernel", "ts": ts, "dur": dur, "name": name}
    tr = {"baseTimeNanoseconds": base_ns,
          "traceEvents": [ev(0, 10, "flash_fwd_kernel<x>"), ev(5, 10), ev(30, 5),
                          {"ph": "X", "cat": "gpu_memcpy", "ts": 40, "dur": 10, "name": "Memcpy"}]}
    by_cat, busy_ms, gaps, first, last = trace.device_breakdown(tr)
    assert busy_ms == pytest.approx(30 / 1e3)   # [0, 15] + [30, 35] + [40, 50]
    assert sorted(g for _, g in gaps) == [5, 15]
    assert by_cat["flash_fwd"] == (pytest.approx(0.01), 1)
    host = [("bench.request", base_ns - 1000, base_ns + 60_000),
            ("bench.unet_call", base_ns + 14_000, base_ns + 20_000)]
    named = trace.named_gaps(tr, gaps, host)
    assert named[0] == ["bench.unet_call", pytest.approx(15e-6)]
    assert named[1] == ["bench.request", pytest.approx(5e-6)]
    summary = trace.summarize(tr, 60e-6)
    assert summary["busy_s"] == pytest.approx(30e-6)
    assert harness.reader("idle_share.gen")({"kind": "gen", "profile": summary}) == \
        pytest.approx(50.0)


def test_flop_counts_match_the_meta_device_figures():
    bt = flops.generation_request(cfg("gligen_sd14_box_text"), 8, 50, [0.3, 0.0, 0.7])
    assert bt["per_row_fusers"] / 1e9 == pytest.approx(1134.0, abs=0.2)
    assert bt["per_row_plain"] / 1e9 == pytest.approx(803.3, abs=0.1)
    assert bt["parts"]["vae_decode"] / 8e9 == pytest.approx(2514.5, abs=0.1)
    assert (bt["fuser_calls"], bt["free_calls"]) == (16, 35)
    hed = flops.generation_request(cfg("gligen_sd14_hed"), 8, 50, [0.9, 0.0, 0.1])
    assert hed["per_row_fusers"] / 1e9 == pytest.approx(1153.0, abs=0.2)
    assert (hed["fuser_calls"], hed["free_calls"]) == (46, 5)


def test_mfu_and_roofline_arithmetic():
    work = {"flops": 760e12, "attention_sites": [(16, 8, 4096, 4096, 40, False, False)]}
    rec = {"kind": "gen", "requests": reqs([(0, 2.0), (2.0, 6.0), (6.0, 8.0)], profiled=(1,)),
           "window_s": 8.0, "work": work,
           "profile": {"by_cat": {"flash_fwd": (1.0, 1)}, "busy_s": 1, "wall_s": 2}}
    # the profiled request is out of both the FLOPs and the window
    assert harness.reader("mfu.gen")(rec) == pytest.approx(100 * 2 * 760e12 / (4.0 * 989e12))
    least = flops.attention_least_s(work["attention_sites"][0])
    assert least == pytest.approx(4 * 16 * 8 * 4096 * 4096 * 40 / 989e12)
    assert harness.reader("attn_roofline.gen")(rec) == pytest.approx(100 * least / 1e-3)


def test_backward_least_time_counts_only_the_gradients_a_site_needs():
    site = (4, 8, 4096, 77, 40)
    assert flops.attention_bwd_least_s(site + (False, False)) == 0.0
    only_q = flops.attention_bwd_least_s(site + (True, False))
    both = flops.attention_bwd_least_s((4, 8, 4096, 4096, 40, True, True))
    assert both == pytest.approx(10 * 4 * 8 * 4096 * 4096 * 40 / 989e12)
    assert 0 < only_q < both


def test_train_step_flops_and_sites():
    work = flops.train_step(cfg("gligen_sd14_box_text"), 2, 512)
    per_image = work["flops"] / 2 / 1e12
    assert 3.6 < per_image < 4.0
    sites = work["attention_sites"]
    assert sum(1 for s in sites if s[5]) == 47 and sum(1 for s in sites if s[6]) == 31


def test_the_check_samples_images_from_the_seed_as_they_come():
    import torch

    from benchmark.traffic.gen_closed import Sample

    def draw(seed, requests=5, batch=4):
        s = Sample(seed, 3)
        for i in range(requests):
            s.offer(i, torch.arange(batch, dtype=torch.float32)[:, None] + 10 * i)
        return [slot for slot, _ in s.kept], [float(img[0]) for _, img in s.kept]

    slots, values = draw(7)
    assert len(slots) == 3 and len(set(slots)) == 3
    assert values == [10 * i + r for i, r in slots]
    assert draw(7) == (slots, values)
    counts = {}
    for seed in range(400):
        for slot in draw(seed)[0]:
            counts[slot] = counts.get(slot, 0) + 1
    assert len(counts) == 20 and min(counts.values()) > 30   # 60 expected each
