"""Share of the build's seconds spent outside the `encode_fn` that
`build_index` was handed (the benchmark's spans around it): the build
loop, the shard and manifest writes, the index's final load, and the
stream handing over batches."""

from benchmark import derive


def read(run):
    if derive.generator(run) != "index" or run.elapsed <= 0:
        return None
    inside = run.spans.seconds("encode_fn")
    return 100.0 * (run.elapsed - inside) / run.elapsed
