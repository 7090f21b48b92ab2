"""Tools of the port: checks that run on a CUDA card, and the serving load
client (bench_serve.py)."""
