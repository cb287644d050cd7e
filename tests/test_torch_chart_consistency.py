"""The GPU chart (``deployment/gpu/helm``) renders, through the port's
helmlite, the same objects as the port's renderer: the cases of
``tests/test_chart_consistency.py`` over the port's chart, its helmlite
and its renderer, the multi-host ones (a StatefulSet and its headless
service in place of the Deployment and its PVC) included; the
node-label cases add GPU product values, capitals and ones YAML would
read as a number or a bool."""

import base64
import pathlib

import pytest
import yaml

from kvedge_torch.config.values import DEFAULT_VALUES
from kvedge_torch.render import render_all, to_yaml
from kvedge_torch.render.helmlite import Chart, HelmLiteError
from kvedge_torch.render.manifests import render_notes

CHART_DIR = str(pathlib.Path(__file__).parent.parent / "deployment" / "gpu"
                / "helm")

VALUE_MATRIX = [
    {},
    {"nameOverride": "my-edge", "publicSshKey": "ssh-ed25519 AAAA op@host"},
    {"tpuRuntimeEnableExternalSsh": False, "tpuRuntimeDiskSize": "32Gi"},
    {"jaxRuntimeConfig": '[runtime]\nname = "edge-x"\n',
     "tpuAccelerator": "NVIDIA-A100-SXM4-80GB"},
    # Empty nameOverride: both renderers fall back to the chart name.
    {"nameOverride": ""},
    # Label values YAML would read as a number or a bool unquoted.
    {"tpuAccelerator": "1234"},
    {"tpuAccelerator": "true"},
    {"jaxRuntimeConfig": '[tpu]\nplatform = "gpu"\n',
     "tpuAccelerator": "NVIDIA-H100-PCIe"},
    # Multi-host: the StatefulSet, the headless service and the pod-0
    # helm test hook in BOTH renderers, with the access Service on or off.
    {"tpuNumHosts": 4,
     "jaxRuntimeConfig": "[distributed]\nnum_processes = 4\n"},
    {"tpuNumHosts": 2, "tpuRuntimeEnableExternalSsh": False,
     "nameOverride": "slice-a",
     "jaxRuntimeConfig": "[distributed]\nnum_processes = 2\n"},
    # Several GPUs a pod: the device request, the memory a rank and the
    # cards' env, on one host and on several.
    {"gpusPerHost": 4, "jaxRuntimeConfig": "[mesh]\naxes = { data = 4 }\n"},
    {"tpuNumHosts": 2, "gpusPerHost": 2,
     "jaxRuntimeConfig": "[distributed]\nnum_processes = 2\n"},
]
SECRETS = ("torch-gpu-boot-config-secret.yaml",
           "torch-gpu-runtime-config-secret.yaml")


@pytest.fixture(scope="module")
def chart():
    return Chart(CHART_DIR)


@pytest.mark.parametrize("overrides", VALUE_MATRIX)
def test_chart_matches_renderer(chart, overrides):
    values = DEFAULT_VALUES.replace(**overrides)
    expected = render_all(values)
    rendered = chart.render(overrides)

    helm_yaml = {n for n in rendered if n.endswith(".yaml")}
    assert helm_yaml == set(expected.manifests), (
        "chart and renderer disagree on which manifests exist"
    )
    for name in helm_yaml:
        helm_doc = yaml.safe_load(rendered[name])
        assert helm_doc == expected.manifests[name], f"drift in {name}"
        # Emitted again, the two are the same bytes.
        assert to_yaml(helm_doc) == to_yaml(expected.manifests[name])


@pytest.mark.parametrize("overrides", VALUE_MATRIX)
def test_boot_config_secret_byte_identical(chart, overrides):
    values = DEFAULT_VALUES.replace(**overrides)
    expected = render_all(values)
    rendered = chart.render(overrides)
    for name in SECRETS:
        helm_payload = base64.b64decode(
            yaml.safe_load(rendered[name])["data"]["userdata"]
        )
        ours_payload = base64.b64decode(
            expected.manifests[name]["data"]["userdata"]
        )
        assert helm_payload == ours_payload, f"secret payload drift in {name}"


@pytest.mark.parametrize("overrides", [
    {}, {"tpuRuntimeEnableExternalSsh": False}, {"nameOverride": "my-edge"},
    {"tpuNumHosts": 4,
     "jaxRuntimeConfig": "[distributed]\nnum_processes = 4\n"},
    {"tpuNumHosts": 2, "tpuRuntimeEnableExternalSsh": False,
     "jaxRuntimeConfig": "[distributed]\nnum_processes = 2\n"},
    {"gpusPerHost": 8},
    {"tpuNumHosts": 2, "gpusPerHost": 4,
     "jaxRuntimeConfig": "[distributed]\nnum_processes = 2\n"}])
def test_notes_match(chart, overrides):
    rendered = chart.render(overrides)
    assert rendered["NOTES.txt"] == render_notes(
        DEFAULT_VALUES.replace(**overrides))


def test_dead_template_is_helmignored(chart):
    assert "torch-gpu-state-volume-prepopulated.yaml" in chart.ignored
    assert "torch-gpu-state-volume-prepopulated.yaml" not in chart.templates
    src = pathlib.Path(CHART_DIR, "templates",
                       "torch-gpu-state-volume-prepopulated.yaml")
    assert src.exists()
    # Rendered anyway, it is the renderer's dead alternative.
    dead = Chart(CHART_DIR)
    dead.templates[src.name] = src.read_text()
    doc = yaml.safe_load(dead.render({})[src.name])
    assert doc == render_all(DEFAULT_VALUES, include_dead=True).manifests[
        src.name]


def test_chart_metadata_matches_package():
    from kvedge_torch.version import (
        APP_VERSION, CHART_DESCRIPTION, CHART_KEYWORDS, CHART_NAME,
        CHART_VERSION,
    )

    meta = yaml.safe_load(pathlib.Path(CHART_DIR, "Chart.yaml").read_text())
    assert meta["name"] == CHART_NAME
    assert str(meta["version"]) == CHART_VERSION
    assert str(meta["appVersion"]) == APP_VERSION
    assert meta["description"] == CHART_DESCRIPTION
    assert tuple(meta["keywords"]) == CHART_KEYWORDS


def test_chart_values_are_the_renderers_defaults(chart):
    import dataclasses

    assert chart.default_values == dataclasses.asdict(DEFAULT_VALUES)


def test_helmlite_rejects_unknown_constructs(chart):
    with pytest.raises(HelmLiteError):
        chart._render_text("{{ .Values.noSuchValue }}",
                           {"Values": dict(chart.default_values)})
    with pytest.raises(HelmLiteError):
        chart._render_text("{{ lookup \"v1\" \"Pod\" }}", {"Values": {}})


def test_tojson_matches_go_html_escaping(chart):
    overrides = {"publicSshKey": "ssh-ed25519 AAAA ops&infra<dev>@host"}
    rendered = chart.render(overrides)
    expected = render_all(DEFAULT_VALUES.replace(**overrides))
    helm_payload = base64.b64decode(
        yaml.safe_load(rendered["torch-gpu-boot-config-secret.yaml"])["data"][
            "userdata"
        ]
    ).decode()
    ours_payload = base64.b64decode(
        expected.manifests["torch-gpu-boot-config-secret.yaml"]["data"][
            "userdata"
        ]
    ).decode()
    assert helm_payload == ours_payload
    assert "\\u0026" in helm_payload and "\\u003c" in helm_payload


def test_define_with_nested_if_not_truncated(chart):
    chart._collect_defines(
        '{{- define "t.nested" -}}A{{- if eq 1 1 }}B{{- end }}C{{ end -}}'
    )
    out = chart._render_text('{{ include "t.nested" . }}', {"Values": {}})
    assert out == "ABC"


def test_mul_is_sprigs_integer_product(chart):
    ctx = {"Values": dict(chart.default_values, gpusPerHost=4)}
    assert chart._render_text("{{ mul 8 .Values.gpusPerHost }}Gi",
                              ctx) == "32Gi"
    assert chart._render_text("{{ mul 2 3 4 }}", ctx) == "24"


def test_helmignore_glob_patterns(chart):
    assert chart._is_ignored("anything.bak")
    assert chart._is_ignored("torch-gpu-runtime.yaml.orig")
    assert not chart._is_ignored("torch-gpu-runtime.yaml")


def test_name_helper_matches_the_renderer(chart):
    """``trunc 40 | trimSuffix "-"`` strips ONE dash, in the chart's
    helper as in ``resource_name`` (long and dash-ended overrides, which
    the values' validation would refuse before a render)."""
    from kvedge_torch.render.names import resource_name

    for override in ("", "my-edge", "a" * 38 + "--", "b" * 39 + "-",
                     "c" * 45, "d" * 40 + "-e"):
        ctx = {"Values": dict(chart.default_values, nameOverride=override)}
        assert chart._render_text('{{ include "kvedgetorch.name" . }}',
                                  ctx) == resource_name(override)
