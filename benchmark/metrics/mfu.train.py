"""mfu.train: the model FLOPs of the window's steps (forward and backward
over each batch's true lengths, benchmark/counts/models.py) over the
window's seconds times the peak of the fastest arithmetic the run
permits: TF32's 495 TFLOP/s where cuBLAS or cuDNN may use TF32, f32's 67
where neither may."""

from benchmark.metrics._readers import peak_share_pct


def read(run):
    return peak_share_pct(run.window.get("model_flops"),
                          run.window.get("seconds"), run.window.get("peak"))
