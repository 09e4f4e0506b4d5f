"""Services layer: fault injection, resiliency, performance counters,
latency histograms, the profiler bridge and the causal tracer.

Counterpart of ``hpx_tpu.svc``, the one-process half (the distributed
halves come with the host distribution plane)."""
