"""Canonical ERA5 / WeatherBench2 variable lists (the parts of
``swift_tpu/data/constants.py`` the port uses).

Same inventory as the reference (src/swift/data/constants.py:1-71,
src/swift/data/utils.py:1-141): 4 surface variables + 5 atmospheric
variables × 13 pressure levels = 69 model variables, plus 3 forcings.
"""

DEFAULT_PRESSURE_LEVELS = [
    50, 100, 150, 200, 250, 300, 400, 500, 600, 700, 850, 925, 1000,
]

PRESSURE_LEVEL_VARS = [
    "geopotential",
    "u_component_of_wind",
    "v_component_of_wind",
    "vertical_velocity",
    "wind_speed",
    "temperature",
    "relative_humidity",
    "specific_humidity",
    "vorticity",
    "potential_vorticity",
]


def compress_variables(variables: list[str]) -> dict[str, list[int]]:
    """"geopotential_500" style names -> {base: [levels]}; surface vars get
    an empty level list (reference src/swift/utils/io.py:73-82)."""
    out: dict[str, list[int]] = {}
    for v in variables:
        parts = v.rsplit("_", 1)
        if len(parts) == 2 and parts[1].isdigit():
            out.setdefault(parts[0], []).append(int(parts[1]))
        else:
            out.setdefault(v, [])
    return out
