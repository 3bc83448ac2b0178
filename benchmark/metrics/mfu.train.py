"""Training operations per image (3 x the forward's convolutions,
`work.flops`) times the untraced window's images/s, over the bf16 dense
peak (`work.peaks`), %."""

from benchmark.work import peaks


def read(records):
    rate = records.get("untraced_images_per_s")
    if not rate:
        return None
    return 100.0 * records["work"]["train_flops_per_image"] * rate / peaks.BF16_DENSE_FLOPS
