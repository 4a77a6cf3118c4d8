"""Plain fp32 references, one module per model family, named by a
configuration file's ``reference`` key. They import torch and nothing of the
program: they work the loss, the gradients and the updated state out again
from the weights and batches the benchmark hands to both sides."""
