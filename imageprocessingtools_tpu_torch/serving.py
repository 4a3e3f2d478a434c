"""Batched end-to-end serving: files -> decode -> device pipeline -> encode.

Counterpart of ``imageprocessingtools_tpu/serving.py``. The reference is one
image per process (decode, op chain, encode, ``ppmx-edward.c:1053-1172``).
This module amortizes codec and device work over many files: files are
bucketed by shape, each bucket is decoded in chunks of at most ``max_batch``
images by the native C++ batch decoder, each chunk is uploaded once to the
device that ``IPT_DEVICE`` names, or in equal shards to the devices of a
mesh (``mesh=``, padded by repeating the last image), and run through the
pipeline there by ``parallel.batch_apply`` (a loop over the images on a
device's stream, where the JAX package has ``vmap``), P4 bits are packed on
the device, and the outputs come back once per chunk (per shard) and are
encoded by the native threaded encoder. A reader and a writer thread
overlap decode and encode with the device.

``process_file_spatial`` takes one giant image in row bands over a mesh
(``parallel/spatial.py``), decoded once and uploaded once for every fan-out
element.

Not ported: the strict-rotation branches, since the port's rotation is exact
and needs no audit.
"""

from __future__ import annotations

import collections
import queue
import threading

import numpy as np

from imageprocessingtools_tpu_torch.codec import native, ppm
from imageprocessingtools_tpu_torch.codec.ppm import FILETYPE_PBM, FILETYPE_PGM
from imageprocessingtools_tpu_torch.models import (
    PRESET_FILE_TYPES,
    get_preset,
    preset_output_shape,
)
from imageprocessingtools_tpu_torch.ops import _exact
from imageprocessingtools_tpu_torch.ops.packing import pack_bits_device
from imageprocessingtools_tpu_torch.parallel import spatial
from imageprocessingtools_tpu_torch.parallel.batch import batch_apply, default_mesh
from imageprocessingtools_tpu_torch.pipeline import PipelineConfig, run_pipeline


def _pipeline_fn(config: PipelineConfig):
    """Single-image fn for a reference config; mono output is packed to P4
    rows on the device."""

    def one(img):
        out, _ = run_pipeline(img, config)
        if config.mono:
            out = pack_bits_device(out)
        return out

    return one


def _preset_pipeline_fn(name: str):
    """(single-image fn, file_type) for a models/ preset name. PBM presets
    pack bits on the device like the reference mono path."""
    fn = get_preset(name)  # raises ValueError for unknown names
    file_type = PRESET_FILE_TYPES[name]

    def one(img):
        out = fn(img)
        if file_type == FILETYPE_PBM:
            out = pack_bits_device(out)
        return out

    return one, file_type


def config_tag(item) -> str:
    """Stable output-name tag for one fan-out element: the preset name for
    a string, or the reference flags in fixed pipeline order for a
    `PipelineConfig` (e.g. ``PipelineConfig(new_width=1920, gray=True)`` ->
    ``"w1920-gray"``). Fan-out outputs are written to
    ``<path>.<tag><suffix>``."""
    if isinstance(item, str):
        return item
    parts = []
    if item.new_width is not None:
        parts.append(f"w{int(item.new_width)}")
    if item.angle is not None:
        a = float(item.angle)
        parts.append(f"r{int(a)}" if a.is_integer() else f"r{a}")
    if item.gray:
        parts.append("gray")
    if item.mono:
        parts.append("mono")
    if item.flip_v:
        parts.append("fv")
    if item.flip_h:
        parts.append("fh")
    if not parts:  # quirk B2: the reference requires at least one op
        raise ValueError("Error: no data to write\n")
    return "-".join(parts)


def _fanout_pipeline_fn(items: tuple):
    """(single-image fn returning one output PER element, file_types tuple)
    for a tuple of preset names and/or `PipelineConfig`s: FAN-OUT serving.
    Every element runs on the same uploaded image, so a chunk is decoded
    and uploaded once for N outputs."""
    if not items:
        raise ValueError("empty fan-out list")
    tags = [config_tag(it) for it in items]  # validates B2 per element
    if len(set(tags)) != len(tags):
        raise ValueError(f"duplicate fan-out outputs: {sorted(tags)}")
    parts = [
        _preset_pipeline_fn(it) if isinstance(it, str)
        else (_pipeline_fn(it), it.file_type)
        for it in items  # _preset_pipeline_fn validates each name
    ]
    fns = tuple(p[0] for p in parts)
    file_types = tuple(p[1] for p in parts)

    def one(img):
        return tuple(fn(img) for fn in fns)

    return one, file_types


def _task_fn(config) -> tuple:
    """(single-image fn, file_type) for a PipelineConfig, preset name, or
    tuple of preset names / PipelineConfigs (fan-out; file_type is then a
    tuple too)."""
    if isinstance(config, tuple):
        return _fanout_pipeline_fn(config)
    if isinstance(config, str):
        return _preset_pipeline_fn(config)
    return _pipeline_fn(config), config.file_type


def _task_unpacked_shape(config, h: int, w: int) -> tuple:
    """Pre-P4-packing output shape for one (h, w, 3) input (the P4 writer
    needs the real width; device packing pads rows to a byte). Computed
    from the preset's stated shape or the shape arithmetic of
    ``ops/_exact.py``, which also raises the reference's resize messages
    (B7, B9) before any file is decoded."""
    if isinstance(config, str):
        return preset_output_shape(config, h, w)
    if not config.any_op:  # quirk B2, raised where the JAX package's trace raises it
        raise ValueError("Error: no data to write\n")
    if config.new_width is not None:
        plan = _exact.plan_resize(h, w, int(config.new_width))
        h, w = plan.new_height, plan.new_width
    if config.angle is not None:
        angle = float(config.angle)
        if angle in (90.0, 270.0):
            h, w = w, h
        elif angle not in (0.0, 180.0):
            w, h = _exact.calc_rot_size(_exact.fold_angle(angle), w, h)
    return (h, w) if (config.gray or config.mono) else (h, w, 3)


def process_batch(images, config: PipelineConfig | str | tuple, mesh: tuple | None = None):
    """uint8[N, H, W, 3] -> (uint8[N, ...] on the device, file_type).

    ``config`` is a PipelineConfig (reference ops), a preset name from
    `models.PRESETS` (P4 presets pack bits on the device), or a tuple of
    preset names and/or PipelineConfigs (fan-out: returns a tuple of
    outputs and a tuple of file_types). The batch is uploaded once; every
    image, and every fan-out element, runs on that copy.
    With a mesh (a tuple of devices), the batch is split into one shard per
    device, each uploaded once, and the output is the list of the shards'
    outputs (``parallel.batch.gather`` joins them); a batch that does not
    divide the mesh is padded by repeating its last image, and the padding
    is sliced off every fan-out element's output.
    """
    one, file_type = _task_fn(config)
    if mesh is None:
        return batch_apply(one, images), file_type
    n = images.shape[0]
    pad = (-n) % len(mesh)
    if pad:
        images = np.concatenate([images, np.repeat(images[-1:], pad, axis=0)], axis=0)
    shards = batch_apply(one, images, mesh=mesh)
    if pad:
        size = images.shape[0] // len(mesh)
        kept = [min(size, max(0, n - k * size)) for k in range(len(shards))]
        shards = [tuple(o[:m] for o in s) if isinstance(s, tuple) else s[:m]
                  for s, m in zip(shards, kept) if m]
    return shards, file_type


def _spatial_task(item):
    """(fn(bands, mesh) -> bands, file_type) for one element of a spatial
    run: ``"fused"``, a preset name or a PipelineConfig."""
    if item == "fused":
        return spatial.fused_pipeline_spatial, FILETYPE_PGM
    if isinstance(item, str):
        get_preset(item)  # raises ValueError for unknown names
        return (lambda bands, mesh: spatial.preset_pipeline_spatial(bands, item, mesh),
                PRESET_FILE_TYPES[item])
    return (lambda bands, mesh: spatial.run_pipeline_spatial(bands, item, mesh),
            item.file_type)


def _write_bands(out_path: str, bands: list, file_type: int, max_color: int) -> None:
    """Encode one image held in bands: P4 bits packed per band on its
    device, the bands joined on the host, written by the native encoder."""
    width = bands[0].data.shape[1]
    if file_type == FILETYPE_PBM:
        bands = [spatial.Band(b.row0, pack_bits_device(b.data)) for b in bands]
    out = spatial.gather(bands).numpy()
    native.encode_batch_files(
        [out_path], out[None], file_type, [max_color],
        p4_dims=(out.shape[0], width) if file_type == FILETYPE_PBM else None)


def process_file_spatial(path: str, config, mesh: tuple | None = None,
                         suffix: str = ".out"):
    """ONE giant image in row bands over a mesh (``parallel/spatial.py``).

    ``config`` is a PipelineConfig (the reference's pipeline), ``"fused"``
    (gray -> 5x5 Gaussian -> histogram equalization, written as P5), a
    preset name, or a tuple of these (fan-out): the file is decoded once and
    its bands uploaded once for every element, each written to
    ``<path>.<tag><suffix>`` (`config_tag`). ``mesh`` defaults to
    ``parallel.batch.default_mesh()``. Writes ``<path><suffix>`` and
    returns its path, or the list of paths for a fan-out.
    """
    if mesh is None:
        mesh = default_mesh()
    items = config if isinstance(config, tuple) else (config,)
    if isinstance(config, tuple):
        tags = [config_tag(it) for it in items]  # validates B2 per element
        if len(set(tags)) != len(tags):
            raise ValueError(f"duplicate fan-out outputs: {sorted(tags)}")
        names = ["." + t + suffix for t in tags]
    else:
        names = [suffix]
    tasks = [_spatial_task(it) for it in items]
    with open(path, "rb") as f:
        img, max_color = ppm.decode_ppm(f.read())
    bands = spatial.shard_rows(img, mesh)
    out_paths = []
    for name, (fn, file_type) in zip(names, tasks):
        out_paths.append(path + name)
        _write_bands(out_paths[-1], fn(bands, mesh), file_type, max_color)
    return out_paths if isinstance(config, tuple) else out_paths[0]


def _encode_chunk(idxs, out_np, file_type, unpacked, paths, metas, suffix,
                  out_paths, names=None) -> None:
    """Host-encode one processed chunk to ``<path><suffix>`` files via the
    threaded native batch encoder; for fan-out (``names`` given) to
    ``<path>.<tag><suffix>`` per element."""
    if names is not None:
        for k, name in enumerate(names):
            files = [paths[i] + "." + name + suffix for i in idxs]
            native.encode_batch_files(
                files, out_np[k], file_type[k],
                [metas[i][2] for i in idxs],
                p4_dims=unpacked[k] if file_type[k] == FILETYPE_PBM else None,
            )
            for j, i in enumerate(idxs):
                out_paths[i][k] = files[j]
        return
    files = [paths[i] + suffix for i in idxs]
    native.encode_batch_files(
        files, out_np, file_type,
        [metas[i][2] for i in idxs],
        p4_dims=unpacked if file_type == FILETYPE_PBM else None,
    )
    for j, i in enumerate(idxs):
        out_paths[i] = files[j]


def _to_host(out):
    """Device output(s) to host numpy; the copy waits for the device.
    Fan-out outputs are a tuple; a mesh's outputs are a list of shards,
    joined here on the host."""
    if isinstance(out, list):
        shards = [_to_host(s) for s in out]
        if len(shards) == 1:
            return shards[0]
        if isinstance(shards[0], tuple):
            return tuple(np.concatenate([s[k] for s in shards]) for k in range(len(shards[0])))
        return np.concatenate(shards)
    if isinstance(out, tuple):
        return tuple(o.cpu().numpy() for o in out)
    return out.cpu().numpy()


def _read_and_decode(paths, idxs, expected_hw, on_error="raise",
                     failures=None):
    """Batch-decode one chunk of files straight into one contiguous array
    (``native.decode_batch_files``). With ``on_error="skip"``, a file that
    fails to open or decode is dropped from the chunk (its message recorded
    in ``failures[i]``). Returns (kept_idxs, batch); batch is None when
    nothing survived."""
    h, w = expected_hw
    batch, errs = native.decode_batch_files([paths[i] for i in idxs], h, w)
    if not errs:
        return list(idxs), batch
    if on_error != "skip":
        kind, msg = errs[min(errs)]
        if kind == "open":
            # The same surface as an unreadable file on the single-file
            # path: the builtin OSError from open().
            with open(paths[idxs[min(errs)]], "rb"):
                pass
            raise OSError(msg)  # opened on retry (race): still fail fast
        raise ppm.PPMError(msg)
    for j, (_, msg) in errs.items():
        failures[idxs[j]] = msg
    kept = [i for j, i in enumerate(idxs) if j not in errs]
    if not kept:
        return [], None
    return kept, batch[np.array([j for j in range(len(idxs)) if j not in errs])]


def process_files(
    paths: list[str],
    config: PipelineConfig | str | tuple | list,
    suffix: str = ".out",
    max_batch: int = 256,
    overlap: bool = True,
    on_error: str = "raise",
    failures: dict | None = None,
    mesh: tuple | None = None,
) -> list[str]:
    """Run the pipeline over many files; writes ``<path><suffix>``.

    ``config`` is a PipelineConfig (the reference's six-flag pipeline), a
    preset name from `models.PRESETS`, or a tuple/list of preset names
    and/or PipelineConfigs: FAN-OUT, where every element runs on one upload
    per chunk and writes ``<path>.<tag><suffix>`` (`config_tag`); the
    return value is then a list of per-input path lists instead of a flat
    path list.

    Files are bucketed by (H, W); each bucket is decoded with the native
    batch codec in chunks of at most ``max_batch`` images (bounding host
    and device memory for e.g. 4096-file runs), processed on the device,
    then encoded on the host. With ``overlap=True`` a reader thread decodes
    chunk N+1 and a writer thread encodes chunk N-1 while the device runs
    chunk N; the queues hold 2 chunks each, so host memory stays at a few
    chunks whatever the file count.

    ``on_error="skip"``: a file that fails to open, parse or decode is
    skipped (input path -> stdout-style message in the caller's
    ``failures`` dict) and the rest of the run proceeds. The default
    ``"raise"`` keeps the reference's fail-fast semantics.

    ``mesh``: split each chunk over these devices (``process_batch``).
    """
    if on_error not in ("raise", "skip"):
        raise ValueError(f"on_error must be 'raise' or 'skip', got {on_error!r}")
    path_failures: dict = {} if failures is None else failures
    fanout_names: tuple | None = None
    fanout_tags: tuple | None = None
    if isinstance(config, (tuple, list)):
        fanout_names = tuple(config)
        config = fanout_names
        _fanout_pipeline_fn(fanout_names)  # validate elements early
        fanout_tags = tuple(config_tag(x) for x in fanout_names)

    # First pass: headers only (a 64 KB prefix and the size of each file),
    # so payloads are read per chunk.
    idx_failures: dict[int, str] = {}
    metas = []
    for i, p in enumerate(paths):
        try:
            w, h, maxval, _ = native.parse_file_header(p)
        except (ppm.PPMError, OSError) as e:
            if on_error != "skip":
                raise
            idx_failures[i] = (
                e.message if isinstance(e, ppm.PPMError)
                else "error. can not open file\n"
            )
            metas.append(None)
            continue
        metas.append((h, w, maxval))

    buckets: dict[tuple[int, int], list[int]] = collections.defaultdict(list)
    for i, m in enumerate(metas):
        if m is not None:
            buckets[(m[0], m[1])].append(i)

    out_paths: list = (
        [[None] * len(fanout_names) for _ in paths]
        if fanout_names is not None else [None] * len(paths)
    )
    for (h, w), all_idxs in buckets.items():
        # Pre-pack spatial dims (resize/rotate may change them before mono).
        if fanout_names is not None:
            unpacked: tuple = tuple(
                _task_unpacked_shape(n, h, w) for n in fanout_names
            )
        else:
            unpacked = _task_unpacked_shape(config, h, w)
        chunks = [
            all_idxs[k : k + max_batch]
            for k in range(0, len(all_idxs), max_batch)
        ]
        if not overlap or len(chunks) == 1:
            for idxs in chunks:
                kept, batch = _read_and_decode(
                    paths, idxs, (h, w), on_error, idx_failures)
                if not kept:
                    continue
                out, file_type = process_batch(batch, config, mesh)
                _encode_chunk(kept, _to_host(out), file_type, unpacked,
                              paths, metas, suffix, out_paths,
                              names=fanout_tags)
            continue

        decode_q: queue.Queue = queue.Queue(maxsize=2)
        encode_q: queue.Queue = queue.Queue(maxsize=2)
        errors: list[BaseException] = []

        def reader():
            try:
                for idxs in chunks:
                    if errors:
                        return
                    kept, batch = _read_and_decode(
                        paths, idxs, (h, w), on_error, idx_failures)
                    if kept:
                        decode_q.put((kept, batch))
            except BaseException as e:  # surfaced in the main thread
                errors.append(e)
            finally:
                decode_q.put(None)

        def writer():
            try:
                while True:
                    item = encode_q.get()
                    if item is None:
                        return
                    _encode_chunk(*item, paths, metas, suffix, out_paths,
                                  names=fanout_tags)
            except BaseException as e:  # surfaced in the main thread
                errors.append(e)

        rt = threading.Thread(target=reader, daemon=True)
        wt = threading.Thread(target=writer, daemon=True)
        rt.start()
        wt.start()

        def put_to_writer(item) -> bool:
            # Bounded put that cannot deadlock on a dead writer: if the
            # writer raised (e.g. disk full in _encode_chunk), its queue
            # stops draining and a plain put() would block forever.
            while wt.is_alive() and not errors:
                try:
                    encode_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            while True:
                item = decode_q.get()
                if item is None:
                    break
                idxs, batch = item
                out, file_type = process_batch(batch, config, mesh)
                if not put_to_writer((idxs, _to_host(out), file_type, unpacked)):
                    break
        except BaseException as e:
            errors.append(e)
        finally:
            # Deliver the writer sentinel. Happy path: the writer is
            # draining, so the timed put succeeds. Error path: drop queued
            # chunks to make room (we are about to raise anyway).
            while wt.is_alive():
                try:
                    encode_q.put(None, timeout=0.1)
                    break
                except queue.Full:
                    if errors:
                        try:
                            encode_q.get_nowait()
                        except queue.Empty:
                            pass
            # Drain so a reader blocked on a full queue can reach its
            # sentinel and exit (otherwise join() deadlocks on early error).
            while rt.is_alive():
                try:
                    decode_q.get_nowait()
                except queue.Empty:
                    rt.join(timeout=0.05)
            rt.join()
            wt.join()
        if errors:
            raise errors[0]
    for i, msg in idx_failures.items():
        path_failures[paths[i]] = msg
    if fanout_names is not None:
        return [o for i, o in enumerate(out_paths) if i not in idx_failures]
    return [p for p in out_paths if p is not None]
