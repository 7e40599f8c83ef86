"""The port's user entry points: `python -m amcslam_tpu_torch.examples.e2e_rendered`
(rendered images through the whole stack) and `python -m
amcslam_tpu_torch.examples.multicam_amv` (the AMV-Bench replay CLI)."""
