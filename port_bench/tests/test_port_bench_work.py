"""port_bench/work/ against hand-worked counts."""

from port_bench import spec
from port_bench.reference import resize

FLAGSHIP = spec.load_json(spec.BENCH / "configs" / "flagship_4k.json")
THUMBNAIL = spec.load_json(spec.BENCH / "configs" / "thumbnail_4k.json")


def test_flagship_work_per_4k_image():
    work = spec.module("work", "flagship_4k").per_image(FLAGSHIP)
    # 24,883,200 bytes read (RGB) and 8,294,400 written (gray): 33.2 MB
    assert work["bytes"] == 2160 * 3840 * 3 + 2160 * 3840 == 33_177_600
    assert work["int_ops"] == 2160 * 3840 * 25 and work["f64_ops"] == 0


def test_thumbnail_taps_follow_the_contribution_tables():
    passes = resize.plan(2160, 3840, 256)
    # equal scales (256/3840 == 144/2160 == 1/15): the width goes first
    assert [axis for axis, _, _ in passes] == [1, 0]
    assert [idx.shape for _, idx, _ in passes] == [(256, 57), (144, 57)]


def test_thumbnail_work_per_4k_image():
    work = spec.module("work", "thumbnail_4k").per_image(THUMBNAIL)
    w_pass = 2160 * 256 * 3 * (2 * 57 + 1)   # a multiply and an add per tap, one rounding
    h_pass = 144 * 256 * 3 * (2 * 57 + 1)
    assert work["f64_ops"] == w_pass + h_pass == 203_489_280
    assert work["bytes"] == 2160 * 3840 * 3 + 144 * 256 * 3 == 24_993_792
    assert work["int_ops"] == 0


def test_least_times_on_the_h100_peaks():
    peaks = spec.load_json(spec.BENCH / "device" / "h100_sxm.json")
    flag = spec.module("work", "flagship_4k").per_image(FLAGSHIP)
    thumb = spec.module("work", "thumbnail_4k").per_image(THUMBNAIL)
    # the flagship is bound by its bytes (9.9 us an image), the thumbnail by
    # its float64 operations (12.0 us)
    assert abs(flag["bytes"] / peaks["bytes_per_s"] - 9.904e-6) < 1e-8
    assert flag["int_ops"] / peaks["int_ops_per_s"] < flag["bytes"] / peaks["bytes_per_s"]
    assert abs(thumb["f64_ops"] / peaks["f64_ops_per_s"] - 11.970e-6) < 1e-8
