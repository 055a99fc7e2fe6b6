"""Launches a round of the port's hand-written kernels (the sum of the
program's ``launches.<wrapper>`` counters: ``adam_moments``,
``matmul_fused``, ``newton_schulz_group``, ``quantize``,
``dequant_accumulate``, ``sophia_update``) in the last traced round, as
its tracer recorded them (``counters.last_traced_round()``)."""


def read(ctx):
    try:
        from repro_torch.obs import counters
    except ImportError:          # a program without the counters
        return None
    last = counters.last_traced_round()
    if last is None:
        return None
    n = [v for k, v in last.items() if k.startswith("launches.")]
    return sum(n) if n else None
