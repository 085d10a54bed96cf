"""bz2tpu command-line tool.

Parity with the reference CLI (app.cpp:31-179): compress by default,
--dec / --check / --keep / --size 1-9 / --parallel N. Differences by design:
- input files are NOT deleted unless --rm is given (the reference deletes by
  default, app.cpp:119-121 — a footgun we do not replicate);
- --backend picks the engine: "xla" (JAX pipeline, default), "device"
  (everything on the device) or "oracle" (pure NumPy reference codec);
- file inputs stream with bounded memory (reference app.cpp:105-116 reads
  128 KiB chunks; we read block-batch-sized chunks);
- standard bzip2 block sizes (level N = N*100k), so output interoperates
  with stock bzip2 both ways;
- --banner prints device discovery info (reference print_device_info,
  include/opencl.hpp:87-107), --metrics a structured JSON metrics line.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bz2tpu",
        description="bzip2 codec on accelerators (JAX/XLA)",
        epilog=(
            "examples: bz2tpu FILE | bz2tpu FILE.bz2 --dec | "
            "bz2tpu FILE.bz2 --check | bz2tpu damaged.bz2 --recover | "
            "cat f | bz2tpu - > f.bz2"
        ),
    )
    from bz2tpu import __version__

    p.add_argument("--version", action="version", version=f"bz2tpu {__version__}")
    p.add_argument(
        "files", nargs="*", metavar="file",
        help="input file(s); '-' for stdin->stdout. Like stock bzip2, "
        "several files process in one invocation — and share one warmed "
        "backend, so only the first pays the startup cost",
    )
    p.add_argument("--dec", action="store_true", help="decompress")
    p.add_argument("--check", action="store_true", help="integrity check only (decode + CRC verify)")
    p.add_argument(
        "--recover", action="store_true",
        help="salvage intact blocks from a damaged .bz2 (bzip2recover analog)",
    )
    p.add_argument("--keep", action="store_true", default=True, help="keep input file (default)")
    p.add_argument("--rm", action="store_true", help="delete input file on success")
    p.add_argument("--size", type=int, default=9, metavar="1-9", help="block size level (N*100k bytes)")
    p.add_argument(
        "--parallel", type=int, default=0, metavar="N",
        help="blocks per device batch (0 = auto)",
    )
    p.add_argument(
        "--backend", choices=["xla", "oracle", "device"], default="xla",
        help="xla: JAX compress + native host decode; oracle: pure NumPy; "
        "device: EVERYTHING on the device (compress: RLE1/split/CRC intake "
        "on device; decompress: Huffman+MTF+IBWT on device)",
    )
    p.add_argument("-o", "--output", help="output path (default: input+.bz2 / strip .bz2)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--metrics", action="store_true", help="print JSON metrics to stderr")
    p.add_argument("--banner", action="store_true", help="print device info to stderr")
    p.add_argument("--trace", metavar="DIR", help="write a JAX profiler trace to DIR")
    p.add_argument(
        "--prime", action="store_true",
        help="pre-compile pipeline shapes for --size (incl. the --backend "
        "device intake at its base window; the 2x/4x/8x escalation windows "
        "ultra-compressible streams can reach still compile on first use) "
        "into the persistent XLA cache (one-time; makes cold runs fast), "
        "then exit",
    )
    p.add_argument(
        "--export-aot", metavar="DIR",
        help="compile the standard pipeline for --size and serialize the "
        "executables into DIR (a shippable artifact; later runs with "
        "BZ2TPU_AOT_DIR=DIR start with zero XLA compilation), then exit",
    )
    return p


def _read_input(args, use_stdio: bool) -> bytes:
    if use_stdio:
        return sys.stdin.buffer.read()
    with open(args.file, "rb") as f:
        return f.read()


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if not 1 <= args.size <= 9:
        print("error: --size must be 1..9", file=sys.stderr)
        return 2
    if args.prime and args.export_aot:
        print("error: --prime and --export-aot are exclusive", file=sys.stderr)
        return 2
    if args.prime or args.export_aot:
        # One pass per process, regardless of how many files were listed
        # (they are not processed — both modes compile and exit).
        if args.files:
            mode = "--prime" if args.prime else "--export-aot"
            print(
                f"note: {mode} compiles and exits; listed files ignored",
                file=sys.stderr,
            )
        if args.prime:
            from bz2tpu.utils.jaxenv import prime

            prime(levels=(args.size,), batch=args.parallel or None, verbose=True)
            return 0
        from bz2tpu.utils.aot import export_artifact

        n = export_artifact(
            args.export_aot, levels=(args.size,), batch=args.parallel or None
        )
        print(f"exported {n} executables to {args.export_aot}", file=sys.stderr)
        return 0
    if not args.files:
        print("error: no input files (or '-' for stdin)", file=sys.stderr)
        return 2
    if len(args.files) > 1:
        if args.output:
            print("error: -o/--output requires a single input file", file=sys.stderr)
            return 2
        if "-" in args.files:
            print("error: '-' (stdio) cannot be mixed with file inputs", file=sys.stderr)
            return 2
        # Stock-bzip2 multi-file semantics: process each in turn; exit
        # status is the worst individual status. One process = one warmed
        # backend for all files.
        worst = 0
        for f in args.files:
            args.file = f
            worst = max(worst, _run_one(args))
        return worst
    args.file = args.files[0]
    return _run_one(args)


def _run_one(args) -> int:
    from bz2tpu.utils.metrics import Clock, RunMetrics

    if args.banner and args.backend == "xla":
        from bz2tpu.utils.device import print_device_banner

        print_device_banner()

    use_stdio = args.file == "-"
    if not use_stdio and not os.path.exists(args.file):
        print(f"error: no such file: {args.file}", file=sys.stderr)
        return 2

    from bz2tpu.utils.profiling import device_trace

    metrics = RunMetrics(level=args.size)
    clock = Clock()
    try:
      with device_trace(args.trace):
        if args.recover:
            from bz2tpu.runtime.decompressor import recover

            metrics.op = "recover"
            data = _read_input(args, use_stdio)
            result, ok, total = recover(data)
            print(f"recovered {ok}/{total} blocks", file=sys.stderr)
            metrics.input_bytes, metrics.output_bytes = len(data), len(result)
            out_path = args.output or (
                args.file[:-4] if args.file.endswith(".bz2") else args.file + ".out"
            )
            if use_stdio:
                sys.stdout.buffer.write(result)
            else:
                with open(out_path, "wb") as f:
                    f.write(result)
            if ok == 0:
                return 1
        elif args.dec or args.check:
            metrics.op = "check" if args.check else "decompress"
            out_path = args.output or (
                args.file[:-4] if args.file.endswith(".bz2") else args.file + ".out"
            )
            if not use_stdio and not args.check and args.backend == "xla":
                # Bounded-memory file-to-file decode (mmap + sliding window).
                from bz2tpu.runtime.decompressor import decompress_file

                decompress_file(args.file, out_path)
                metrics.input_bytes = os.path.getsize(args.file)
                metrics.output_bytes = os.path.getsize(out_path)
            else:
                data = _read_input(args, use_stdio)
                if args.backend == "oracle":
                    from bz2tpu.oracle import decompress
                elif args.backend == "device":
                    from bz2tpu.runtime.device_decode import (
                        decompress_device as decompress,
                    )
                else:
                    from bz2tpu.runtime.decompressor import decompress
                result = decompress(data)
                metrics.input_bytes, metrics.output_bytes = len(data), len(result)
                if args.check:
                    metrics.seconds = clock.elapsed()
                    if args.metrics:
                        print(metrics.to_json(), file=sys.stderr)
                    print("Integrity check passed!")
                    return 0
                if use_stdio:
                    sys.stdout.buffer.write(result)
                else:
                    with open(out_path, "wb") as f:
                        f.write(result)
        else:
            metrics.op = "compress"
            out_path = args.output or (args.file + ".bz2")
            if args.backend == "device":
                # Fully-device pipeline: RLE1 + split + CRC + encode on device.
                from bz2tpu.runtime.compressor import compress_device_intake

                data = _read_input(args, use_stdio)
                result = compress_device_intake(
                    data, level=args.size, parallel=args.parallel or None
                )
                metrics.input_bytes, metrics.output_bytes = len(data), len(result)
                if use_stdio:
                    sys.stdout.buffer.write(result)
                else:
                    with open(out_path, "wb") as f:
                        f.write(result)
            elif args.backend == "oracle":
                from bz2tpu.oracle import compress

                data = _read_input(args, use_stdio)
                result = compress(data, level=args.size)
                metrics.input_bytes, metrics.output_bytes = len(data), len(result)
                if use_stdio:
                    sys.stdout.buffer.write(result)
                else:
                    with open(out_path, "wb") as f:
                        f.write(result)
            elif use_stdio:
                from bz2tpu.runtime.compressor import compress

                data = sys.stdin.buffer.read()
                result = compress(data, level=args.size, parallel=args.parallel or None)
                metrics.input_bytes, metrics.output_bytes = len(data), len(result)
                sys.stdout.buffer.write(result)
            else:
                from bz2tpu.runtime.stream import compress_file

                compress_file(
                    args.file, out_path,
                    level=args.size, parallel=args.parallel or None, metrics=metrics,
                )
                metrics.input_bytes = os.path.getsize(args.file)
                metrics.output_bytes = os.path.getsize(out_path)
    except Exception as e:  # noqa: BLE001 — CLI boundary
        print(f"error: {e}", file=sys.stderr)
        return 1
    metrics.seconds = clock.elapsed()

    if args.metrics:
        print(metrics.to_json(), file=sys.stderr)
    if args.verbose:
        print(
            f"{metrics.input_bytes} -> {metrics.output_bytes} bytes "
            f"({metrics.ratio:.3f}) in {metrics.seconds:.3f}s "
            f"({metrics.mb_per_s:.1f} MB per second)",
            file=sys.stderr,
        )
    if args.rm and not use_stdio:
        os.remove(args.file)
    return 0


if __name__ == "__main__":
    sys.exit(main())
