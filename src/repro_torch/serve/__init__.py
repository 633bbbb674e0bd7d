"""serve layer of the PyTorch port."""


def not_ported(what: str, slice_name: str) -> NotImplementedError:
    """The error a feature of a later ROADMAP slice raises."""
    return NotImplementedError(
        f"{what} is not ported yet: it belongs to the ROADMAP slice "
        f"'{slice_name}'")
