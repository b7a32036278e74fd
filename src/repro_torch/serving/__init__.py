"""Continuous-batching serving over paged KV."""
