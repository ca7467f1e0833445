"""Host seconds of the host coder (rANS and the sparse transport's host
half) per step: the benchmark's host-clock spans around
``StemVideoPipeline.code_sparse_buffer`` and its host decode, or, on the
wavefront path, the host entries of the model's stage clock
(``enc_host_s`` + ``host_rans_s``)."""


def read(run):
    if run.host_coder_s is None or not run.steps:
        return None
    return run.host_coder_s * 1e3 / run.steps
