"""LM serving: the continuous-batching ``ServeEngine`` (dense and paged KV caches,
speculative drafters), its slot scheduler and page table, and the lockstep
``static_generate``."""
