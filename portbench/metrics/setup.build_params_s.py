"""setup.build_params_s: host seconds of ``pipeline.build_decoder_params``
in set-up (the host clock around it, the device synchronized)."""


def read(run):
    return run.timings.get("build_params_s")
