"""Mean time of RoutedInference.route, the Scene Router's decision, per
request in the traced run's window: a span the benchmark wraps around
the instance's public call, fenced by a synchronize on each side. Serves
``route_ms.serve``."""


def read(ctx):
    if not ctx.route_s:
        return None
    return 1e3 * sum(ctx.route_s) / len(ctx.route_s)
