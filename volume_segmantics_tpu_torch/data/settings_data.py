"""Settings validation for library entry points (the part of the JAX
package's `data/settings_data.py` that the in-memory prediction path
reads; YAML loading and the typed schemas are not ported yet)."""


class SettingsError(ValueError):
    """A settings mapping failed validation against its workflow schema."""


def require_settings(settings, keys, context: str) -> None:
    """Raise SettingsError listing EVERY missing key, for library entry
    points fed hand-built namespaces that bypassed the typed loaders (the
    reference dies with a bare AttributeError at first deep use)."""
    missing = [k for k in keys if not hasattr(settings, k)]
    if missing:
        raise SettingsError(
            f"{context} settings are missing required key(s): "
            f"{', '.join(repr(k) for k in missing)}."
        )
