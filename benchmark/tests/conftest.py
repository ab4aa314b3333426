"""Each xdist worker takes few threads: several workers share the CPU."""

import torch

torch.set_num_threads(min(2, torch.get_num_threads()))
