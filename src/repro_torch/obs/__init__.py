"""Observability for the port: the bounded latency histogram.  Trace
spans are ``torch.profiler.record_function`` ranges named as in ``repro``
(``serve.request``, ``serve.dispatch``, ``serve.bucket``)."""
