"""v2 pooling-type objects (python/paddle/v2/pooling.py parity).
`paddle.layer.pooling(input, pooling_type=paddle.pooling.Max())`."""


class BasePoolingType:
    name = "max"

    def __repr__(self):
        return type(self).__name__ + "()"


class Max(BasePoolingType):
    name = "max"


class Avg(BasePoolingType):
    name = "average"


class Sum(BasePoolingType):
    name = "sum"


def pool_name(pool_type, default="max", allowed=("max", "average", "sum"),
              aliases=None):
    """Normalize a v2 pooling object / string to a backend pool name;
    unknown types raise instead of silently pooling differently."""
    if pool_type is None:
        return default
    name = getattr(pool_type, "name", pool_type)
    name = str(name).lower()
    name = (aliases or {}).get(name, name)
    if name not in allowed:
        raise ValueError("unknown pooling type %r (allowed: %s)"
                         % (pool_type, ", ".join(allowed)))
    return name


__all__ = ["Max", "Avg", "Sum", "pool_name"]
