"""The port's GPU render (``kvedge_torch/render``) against the JAX
package's renderer for the same values.

Each case renders both packages from the same values, with a runtime TOML
(``[tpu] platform = "gpu"``) that both ``RuntimeConfig``s parse. The JAX
render's manifest keys are renamed (``jax-tpu-*`` -> ``torch-gpu-*``),
then :func:`allowed` — the table of every difference the port is allowed,
a JSON path in one manifest -> the port's value — is written into it, and
the result must equal the port's render whole: a difference the table
does not list fails. The NOTES are held the same way. Then the pieces:
the name helper, the Go JSON encoder, the values' validation (the GPU
label), the multi-host set (a StatefulSet of one-GPU pods, its headless
service, the topology check), the boot document and the copies that
must stay verbatim.
"""

import base64
import copy
import inspect

import pytest

from kvedge_tpu.config import values as jvalues
from kvedge_tpu.render import bootconfig as jbootconfig
from kvedge_tpu.render import emit as jemit
from kvedge_tpu.render import helmlite as jhelmlite
from kvedge_tpu.render import names as jnames
from kvedge_tpu.render import render_all as jax_render_all
from kvedge_tpu.render.manifests import render_notes as jax_render_notes
from kvedge_tpu.utils.gojson import go_json as jax_go_json
from kvedge_tpu import version as jversion
from kvedge_tpu.bootstrap import bootdoc as jbootdoc
from kvedge_torch.bootstrap import bootdoc
from kvedge_torch.config import values
from kvedge_torch.config.values import DEFAULT_VALUES, ChartValues
from kvedge_torch.render import bootconfig, emit, helmlite, manifests, names
from kvedge_torch.render import render_all
from kvedge_torch.render.manifests import render_notes
from kvedge_torch.utils.gojson import go_json
from kvedge_torch import version

GPU_TOML = '[runtime]\nname = "edge-gpu"\n[tpu]\nplatform = "gpu"\n'
PORT_TOML = GPU_TOML + "[status]\nport = 9100\n"
MULTI_TOML = "[distributed]\nnum_processes = 2\n"

CASES = {
    "default": {"jaxRuntimeConfig": GPU_TOML},
    "custom-port": {"jaxRuntimeConfig": PORT_TOML},
    "ssh-off": {"jaxRuntimeConfig": GPU_TOML,
                "tpuRuntimeEnableExternalSsh": False},
    "name-override": {"jaxRuntimeConfig": GPU_TOML, "nameOverride": "my-edge",
                      "publicSshKey": "ssh-ed25519 AAAA ops&infra<dev>@host"},
    "multihost": {"jaxRuntimeConfig": GPU_TOML + MULTI_TOML,
                  "tpuNumHosts": 2},
    "multihost-ssh-off": {"jaxRuntimeConfig": GPU_TOML + MULTI_TOML,
                          "tpuNumHosts": 2,
                          "tpuRuntimeEnableExternalSsh": False},
    # The port's own value (the JAX renders of these cases leave it out).
    "gpus-4": {"jaxRuntimeConfig": GPU_TOML + "[mesh]\naxes = { data = 4 }\n",
               "gpusPerHost": 4},
    "multihost-gpus-4": {"jaxRuntimeConfig": GPU_TOML + MULTI_TOML + (
        "[mesh]\naxes = { data = 0, model = 4 }\n"),
        "tpuNumHosts": 2, "gpusPerHost": 4},
}

# The boot document's three comment lines about the image: the only
# lines in which the two packages' documents differ.
JAX_IMAGE_COMMENT = (
    "# Once the pod is started the following commands apply the injected\n"
    "# runtime config and boot the JAX runtime. The runtime image ships\n"
    "# with jax[tpu] preinstalled, so there is no package-install step.\n")
PORT_IMAGE_COMMENT = (
    "# Once the pod is started the following commands apply the injected\n"
    "# runtime config and boot the PyTorch runtime on the GPU. The image\n"
    "# ships PyTorch for CUDA and the built kernels: no install step.\n")

DEP = "torch-gpu-runtime.yaml"
PVC = "torch-gpu-state-volume.yaml"
CFG = "torch-gpu-runtime-config-secret.yaml"
BOOT = "torch-gpu-boot-config-secret.yaml"
SVC = "torch-gpu-runtime-service.yaml"
HZ = "torch-gpu-healthz-test.yaml"
STS = "torch-gpu-runtime-multihost.yaml"
HOSTS = "torch-gpu-hosts-service.yaml"
HZM = "torch-gpu-healthz-test-multihost.yaml"
POD = ("spec", "template", "spec")
CTR = POD + ("containers", 0)
DOMAIN = "kvedge.dev/domain"


def _b64(text):
    return base64.b64encode(text.encode()).decode()


def _unb64(text):
    return base64.b64decode(text).decode()


def allowed(v: ChartValues, jax_doc: str) -> dict:
    """Every difference the port's render may have from the JAX
    package's for values ``v``: ``{(manifest, path): the port's value}``.
    ``jax_doc`` is the JAX boot document, whose comment lines change."""
    name = v.nameOverride or "kvedge-torch"   # the port's chart name
    rt = f"{name}-runtime"
    multi = v.tpuNumHosts > 1
    # The workload: the Deployment and its PVC, or the StatefulSet
    # (whose volumes lose the state claim to its claim templates).
    work, first = (STS, 0) if multi else (DEP, 1)
    table = {
        # The GPU node label, the image, the modules the containers run,
        # the device request and the memory request.
        (work, POD + ("nodeSelector",)): {
            "nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3"},
        (work, CTR + ("image",)): "kvedgedev/torch-gpu-runtime:0.1.0",
        (work, CTR + ("command", 6)): "kvedge_torch.bootstrap.entrypoint",
        (work, CTR + ("resources", "requests", "memory")):
            f"{8 * v.gpusPerHost}Gi",
        (work, CTR + ("resources", "limits")): {
            "nvidia.com/gpu": v.gpusPerHost},
        (BOOT, ("data", "userdata")): _b64(
            jax_doc.replace(JAX_IMAGE_COMMENT, PORT_IMAGE_COMMENT)),
        # The default name prefix is the chart's name, kvedge-torch.
        (work, ("metadata", "name")): rt,
        (work, ("spec", "selector", "matchLabels", DOMAIN)): rt,
        (work, ("spec", "template", "metadata", "labels", DOMAIN)): rt,
        (work, POD + ("volumes", first, "secret", "secretName")):
            f"{rt}-jaxconfig",
        (work, POD + ("volumes", first + 1, "secret", "secretName")):
            f"{rt}-bootconfig",
        (CFG, ("metadata", "name")): f"{rt}-jaxconfig",
        (BOOT, ("metadata", "name")): f"{rt}-bootconfig",
    }
    if multi:
        table.update({
            (STS, ("spec", "serviceName")): f"{rt}-hosts",
            (STS, CTR + ("env", 0, "value")): f"{rt}-0.{rt}-hosts",
            (HOSTS, ("metadata", "name")): f"{rt}-hosts",
            (HOSTS, ("spec", "selector", DOMAIN)): rt,
        })
    else:
        table.update({
            (DEP, POD + ("volumes", 0, "persistentVolumeClaim",
                         "claimName")): f"{rt}-dv",
            (PVC, ("metadata", "name")): f"{rt}-dv",
        })
    if v.gpusPerHost > 1:
        # The cards re-stated to the runtime after the JAX env.
        env = ([{"name": "KVEDGE_COORDINATOR", "value": f"{rt}-0.{rt}-hosts"},
                {"name": "KVEDGE_EXPECTED_PROCESSES",
                 "value": str(v.tpuNumHosts)}] if multi else
               [{"name": "KVEDGE_EXPECTED_PROCESSES", "value": "1"}])
        table[(work, CTR + ("env",))] = env + [
            {"name": "KVEDGE_EXPECTED_CARDS", "value": str(v.gpusPerHost)}]
    port = manifests.status_port(v)
    if v.tpuRuntimeEnableExternalSsh:
        table.update({
            (SVC, ("metadata", "name")): f"{rt}-ssh-service",
            (SVC, ("spec", "selector", DOMAIN)): rt,
        })
    if multi or v.tpuRuntimeEnableExternalSsh:
        hz, host = (HZM, f"{rt}-0.{rt}-hosts") if multi else (
            HZ, f"{rt}-ssh-service")
        table.update({
            (hz, ("metadata", "name")): f"{rt}-healthz-test",
            (hz, ("spec", "containers", 0, "image")):
                "kvedgedev/torch-gpu-runtime:0.1.0",
            (hz, ("spec", "containers", 0, "command", 2)):
                "kvedge_torch.runtime.healthcheck",
            (hz, ("spec", "containers", 0, "command", 3)):
                f"http://{host}:{port}/healthz",
        })
    return table


def _set(doc, path, value):
    for key in path[:-1]:
        doc = doc[key]
    doc[path[-1]]  # the path must exist in the JAX render
    doc[path[-1]] = value


def _jax_overrides(overrides):
    """The values the JAX package reads: all but the port's own."""
    return {k: v for k, v in overrides.items() if k != "gpusPerHost"}


def _renders(overrides):
    theirs = jax_render_all(jvalues.DEFAULT_VALUES.replace(
        **_jax_overrides(overrides)))
    ours = render_all(DEFAULT_VALUES.replace(**overrides))
    return theirs, ours


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_is_the_jax_render_but_for_the_listed_differences(case):
    overrides = CASES[case]
    theirs, ours = _renders(overrides)
    expected = {key.replace("jax-tpu-", "torch-gpu-", 1): copy.deepcopy(doc)
                for key, doc in theirs.manifests.items()}
    jax_doc = _unb64(
        theirs.manifests["jax-tpu-boot-config-secret.yaml"]["data"]["userdata"])
    assert jax_doc.count(JAX_IMAGE_COMMENT) == 1
    for (key, path), value in allowed(
            DEFAULT_VALUES.replace(**overrides), jax_doc).items():
        _set(expected[key], path, value)
    assert sorted(expected) == sorted(ours.manifests)
    for key in expected:
        assert ours.manifests[key] == expected[key], key
    # The runtime TOML travels unchanged.
    assert _unb64(ours.manifests[CFG]["data"]["userdata"]) == \
        overrides["jaxRuntimeConfig"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_notes_are_the_jax_notes_but_for_the_chart_and_runtime(case):
    overrides = CASES[case]
    v = DEFAULT_VALUES.replace(**overrides)
    theirs = jax_render_notes(jvalues.DEFAULT_VALUES.replace(
        **_jax_overrides(overrides)))
    if not v.nameOverride:
        theirs = theirs.replace("kvedge-tpu-runtime", "kvedge-torch-runtime")
    theirs = theirs.replace("of kvedge-tpu.", "of kvedge-torch.").replace(
        "JAX TPU runtime", "PyTorch GPU runtime")
    if v.gpusPerHost > 1:
        theirs = theirs.replace(
            "\n\nTo query",
            f"\nEach pod runs one rank on each of its {v.gpusPerHost} GPUs; "
            "the config TOML's [mesh] spans tpuNumHosts x gpusPerHost = "
            f"{v.tpuNumHosts * v.gpusPerHost} GPUs.\n\nTo query", 1)
    assert render_notes(v) == theirs
    assert render_all(v).notes == theirs


def test_rendered_set_and_the_gpu_request():
    chart = render_all(DEFAULT_VALUES)
    assert set(chart.manifests) == {DEP, PVC, CFG, BOOT, SVC, HZ}
    ctr = chart.manifests[DEP]["spec"]["template"]["spec"]["containers"][0]
    assert ctr["resources"]["limits"] == {"nvidia.com/gpu": 1}
    assert ctr["command"][4:7] == ["python", "-m",
                                   "kvedge_torch.bootstrap.entrypoint"]
    off = render_all(DEFAULT_VALUES.replace(tpuRuntimeEnableExternalSsh=False))
    assert set(off.manifests) == {DEP, PVC, CFG, BOOT}
    full = render_all(DEFAULT_VALUES, include_dead=True)
    dead = full.manifests["torch-gpu-state-volume-prepopulated.yaml"]
    assert dead["metadata"]["name"] == full.manifests[PVC]["metadata"]["name"]


def test_render_validates_the_runtime_toml_with_the_ports_parser():
    with pytest.raises(ValueError, match="port 0"):
        render_all(DEFAULT_VALUES.replace(
            jaxRuntimeConfig="[status]\nport = 0\n"))
    with pytest.raises(ValueError, match="num_processes=2 but tpuNumHosts=1"):
        render_all(DEFAULT_VALUES.replace(
            jaxRuntimeConfig="[distributed]\nnum_processes = 2\n"))
    with pytest.raises(ValueError, match="n_experts"):
        render_all(DEFAULT_VALUES.replace(
            jaxRuntimeConfig="[model]\nn_experts = 4\n"))


# ---- names, JSON, version ------------------------------------------------


@pytest.mark.parametrize("override", [
    "", "my-edge", "a" * 39 + "-", "a" * 40 + "-x", "b" * 38 + "--",
    "edge-", "x" * 60])
def test_resource_name_has_the_reference_semantics(override):
    for chart in ("kvedge-tpu", "kvedge-torch", "c" * 39 + "-"):
        assert names.resource_name(override, chart_name=chart) == \
            jnames.resource_name(override, chart_name=chart)
    expected = jnames.resource_name(override, chart_name="kvedge-torch")
    assert names.resource_name(override) == expected
    assert names.common_labels() == jnames.common_labels()
    assert (names.DOMAIN_LABEL, names.OS_LABEL) == \
        (jnames.DOMAIN_LABEL, jnames.OS_LABEL)


def test_resource_name_trims_one_dash_only():
    assert names.resource_name("a" * 38 + "--") == "a" * 38 + "-"
    assert names.resource_name("") == "kvedge-torch"


@pytest.mark.parametrize("text", [
    "", "ssh-ed25519 AAAA op@host", "a&b<c>d", 'quote " and \\ back',
    "tab\tnew\nline", "unicode é ☃", "<script>&amp;</script>"])
def test_go_json_equals_the_reference(text):
    assert go_json(text) == jax_go_json(text)
    assert go_json({"k": [text, 1, True, None]}) == \
        jax_go_json({"k": [text, 1, True, None]})


def test_version_and_the_verbatim_copies():
    assert version.CHART_NAME == "kvedge-torch"
    assert (version.CHART_VERSION, version.APP_VERSION) == \
        (jversion.CHART_VERSION, jversion.APP_VERSION)
    assert "GPU" in version.CHART_DESCRIPTION
    assert "gpu" in version.CHART_KEYWORDS
    assert inspect.getsource(emit) == inspect.getsource(jemit)
    ours = inspect.getsource(helmlite).replace("kvedge_torch.", "kvedge_tpu.")
    # The reference's helmlite and sprig's ``mul``, which the port's
    # chart multiplies the memory a rank by.
    mul = inspect.getsource(helmlite.Chart._call)
    mul = mul[mul.index('        if func == "mul":'):
              mul.index('        if func == "eq":')]
    assert mul.count("\n") == 6 and "out *= int(v)" in mul
    assert ours.replace(mul, "").replace(", ``mul``", "") == \
        inspect.getsource(jhelmlite)
    assert inspect.getsource(values.parse_set_flag) == \
        inspect.getsource(jvalues.parse_set_flag)
    assert inspect.getsource(values.parse_set_file_flag) == \
        inspect.getsource(jvalues.parse_set_file_flag)


# ---- values --------------------------------------------------------------


def test_values_keep_the_reference_fields():
    import dataclasses

    ours = [(f.name, f.type) for f in dataclasses.fields(ChartValues)]
    theirs = [(f.name, f.type)
              for f in dataclasses.fields(jvalues.ChartValues)]
    # The reference's fields, then the port's own gpusPerHost.
    assert ours == theirs + [("gpusPerHost", "int")]
    for f in dataclasses.fields(jvalues.ChartValues):
        if f.name != "tpuAccelerator":
            assert getattr(DEFAULT_VALUES, f.name) == \
                getattr(jvalues.DEFAULT_VALUES, f.name)
    assert DEFAULT_VALUES.tpuAccelerator == "NVIDIA-H100-80GB-HBM3"
    assert DEFAULT_VALUES.gpusPerHost == 1


@pytest.mark.parametrize("hosts,gpus,axes", [
    (1, 4, "{ data = 4 }"), (2, 4, "{ data = 0, model = 4 }")],
    ids=["single-host", "multihost"])
def test_gpus_per_host_asks_for_the_cards_and_states_them(hosts, gpus, axes):
    """Each pod asks for its cards, 8Gi a rank, and re-states the count
    as ``KVEDGE_EXPECTED_CARDS`` (the boot holds it to the cards seen)."""
    toml = f"[mesh]\naxes = {axes}\n" + (
        f"[distributed]\nnum_processes = {hosts}\n" if hosts > 1 else "")
    chart = render_all(DEFAULT_VALUES.replace(
        tpuNumHosts=hosts, gpusPerHost=gpus, jaxRuntimeConfig=toml))
    ctr = chart.manifests[STS if hosts > 1 else DEP]["spec"]["template"][
        "spec"]["containers"][0]
    env = {e["name"]: e["value"] for e in ctr["env"]}
    assert env["KVEDGE_EXPECTED_CARDS"] == "4"
    assert env["KVEDGE_EXPECTED_PROCESSES"] == str(hosts)
    assert ctr["resources"] == {"requests": {"cpu": "4", "memory": "32Gi"},
                                "limits": {"nvidia.com/gpu": 4}}
    assert manifests.pod_memory(DEFAULT_VALUES) == "8Gi"


@pytest.mark.parametrize("hosts,gpus,axes", [
    (1, 4, "{ data = 2 }"), (1, 2, "{ data = 0, model = 4 }"),
    (2, 2, "{ data = 2, model = 1 }"), (1, 1, "{ data = 2 }")])
def test_a_mesh_that_does_not_span_the_cards_fails_the_render(hosts, gpus,
                                                             axes):
    toml = f"[mesh]\naxes = {axes}\n" + (
        f"[distributed]\nnum_processes = {hosts}\n" if hosts > 1 else "")
    with pytest.raises(ValueError) as e:
        render_all(DEFAULT_VALUES.replace(
            tpuNumHosts=hosts, gpusPerHost=gpus, jaxRuntimeConfig=toml))
    assert str(e.value).startswith(
        f"tpuNumHosts={hosts} x gpusPerHost={gpus} = {hosts * gpus} cards "
        "but the runtime config declares [mesh] axes = ")
    assert "the pods' cards and the mesh must match" in str(e.value)


def test_gpus_per_host_is_the_ports_own_value():
    """Validated as tpuNumHosts is; the JAX package's values refuse it,
    so a values file that sets it drives only the port's chart."""
    for bad in (0, True, "2"):
        with pytest.raises(ValueError, match="gpusPerHost must be a "
                                             "positive integer"):
            DEFAULT_VALUES.replace(gpusPerHost=bad)
    assert values.parse_set_flag(DEFAULT_VALUES, "gpusPerHost=4") == \
        DEFAULT_VALUES.replace(gpusPerHost=4)
    with pytest.raises(ValueError, match="unknown value 'gpusPerHost'"):
        jvalues.parse_set_flag(jvalues.DEFAULT_VALUES, "gpusPerHost=4")


@pytest.mark.parametrize("label", [
    "NVIDIA-H100-80GB-HBM3", "NVIDIA-H100-PCIe", "NVIDIA-A100-SXM4-80GB",
    "Tesla-T4", "a", "tpu-v5-lite-podslice", "x.y_z-1", "A" * 63])
def test_gpu_labels_pass(label):
    assert DEFAULT_VALUES.replace(tpuAccelerator=label).tpuAccelerator == label
    render_all(DEFAULT_VALUES.replace(tpuAccelerator=label))


@pytest.mark.parametrize("label", [
    "", "-NVIDIA", "NVIDIA-", "has space", "a/b", "A" * 64, "x:y", ".x"])
def test_bad_labels_refused(label):
    with pytest.raises(ValueError, match="node-label value"):
        DEFAULT_VALUES.replace(tpuAccelerator=label)


def test_the_tpu_check_would_refuse_the_gpu_label():
    with pytest.raises(ValueError):
        jvalues.DEFAULT_VALUES.replace(
            tpuAccelerator=DEFAULT_VALUES.tpuAccelerator)


@pytest.mark.parametrize("field,value,match", [
    ("nameOverride", "My-Edge", "resource-name prefix"),
    ("nameOverride", "edge_1", "resource-name prefix"),
    ("tpuRuntimeDiskSize", "4GB", "quantity"),
    ("tpuRuntimeDiskSize", "0Gi", "quantity"),
    ("tpuRuntimeEnableExternalSsh", "yes", "bool"),
    ("tpuNumHosts", 0, "positive integer"),
    ("tpuNumHosts", True, "positive integer")])
def test_values_validation_matches_the_reference(field, value, match):
    with pytest.raises(ValueError, match=match):
        DEFAULT_VALUES.replace(**{field: value})
    with pytest.raises(ValueError, match=match):
        jvalues.DEFAULT_VALUES.replace(**{field: value})


MULTIHOST = DEFAULT_VALUES.replace(tpuNumHosts=4, jaxRuntimeConfig=(
    "[distributed]\nnum_processes = 4\n"))


def test_multihost_render_swaps_workload_and_adds_hosts_service():
    chart = render_all(MULTIHOST)
    assert set(chart.manifests) == {STS, HOSTS, CFG, BOOT, SVC, HZM}
    spec = chart.manifests[STS]["spec"]
    assert chart.manifests[STS]["kind"] == "StatefulSet"
    assert (spec["replicas"], spec["podManagementPolicy"],
            spec["serviceName"]) == (4, "Parallel", "kvedge-torch-runtime-hosts")
    pod = spec["template"]["spec"]
    # The ordinal hostname is the identity the runtime's process id comes
    # from: no hostname override.
    assert "hostname" not in pod
    ctr = pod["containers"][0]
    env = {e["name"]: e["value"] for e in ctr["env"]}
    assert env == {
        "KVEDGE_COORDINATOR":
            "kvedge-torch-runtime-0.kvedge-torch-runtime-hosts",
        "KVEDGE_EXPECTED_PROCESSES": "4"}
    assert ctr["resources"]["limits"] == {"nvidia.com/gpu": 1}
    assert [v["name"] for v in pod["volumes"]] == ["jaxconfigdisk",
                                                   "bootconfigdisk"]
    claim = spec["volumeClaimTemplates"][0]
    assert claim["metadata"]["name"] == "statedisk"
    assert claim["spec"]["resources"]["requests"]["storage"] == "4Gi"
    assert values.parse_set_flag(DEFAULT_VALUES, "tpuNumHosts=2") == \
        DEFAULT_VALUES.replace(tpuNumHosts=2)


def test_multihost_hosts_service_is_headless_and_follows_the_port():
    svc = render_all(MULTIHOST).manifests[HOSTS]["spec"]
    assert (svc["clusterIP"], svc["publishNotReadyAddresses"],
            svc["ports"][0]["port"]) == ("None", True, 8478)
    chart = render_all(DEFAULT_VALUES.replace(
        tpuNumHosts=2, jaxRuntimeConfig=(
            "[distributed]\nnum_processes = 2\ncoordinator_port = 9100\n")))
    assert chart.manifests[HOSTS]["spec"]["ports"][0]["port"] == 9100


@pytest.mark.parametrize("hosts,toml", [
    (4, "[distributed]\nnum_processes = 2\n"), (4, ""),
    (1, "[distributed]\nnum_processes = 4\n")])
def test_multihost_topology_mismatch_fails_at_render(hosts, toml):
    """The chart's shape and the TOML's world must agree, both ways, as
    the reference's renderer holds them (its messages)."""
    v = DEFAULT_VALUES.replace(tpuNumHosts=hosts, jaxRuntimeConfig=toml)
    with pytest.raises(ValueError) as ours:
        render_all(v)
    with pytest.raises(ValueError) as theirs:
        jax_render_all(jvalues.DEFAULT_VALUES.replace(
            tpuNumHosts=hosts, jaxRuntimeConfig=toml))
    assert str(ours.value) == str(theirs.value).replace(
        "the JAX process group", "the process group")


def test_multihost_notes_name_statefulset():
    notes = render_notes(MULTIHOST)
    assert "kubectl get statefulset kvedge-torch-runtime" in notes
    assert "deployment" not in notes and "helm test" in notes


@pytest.mark.parametrize("assignment", [
    "nope=1", "tpuRuntimeEnableExternalSsh=maybe", "tpuNumHosts=x",
    "publicSshKey", "nameOverride=Bad"])
def test_set_flag_errors_are_the_references(assignment):
    with pytest.raises(ValueError) as ours:
        values.parse_set_flag(DEFAULT_VALUES, assignment)
    with pytest.raises(ValueError) as theirs:
        jvalues.parse_set_flag(jvalues.DEFAULT_VALUES, assignment)
    assert str(ours.value) == str(theirs.value)


def test_set_flags_drive_both_renders(tmp_path):
    path = tmp_path / "config.toml"
    path.write_text(PORT_TOML)
    ours, theirs = DEFAULT_VALUES, jvalues.DEFAULT_VALUES
    for assignment in ("nameOverride=edge-a", "tpuRuntimeDiskSize=32Gi",
                       "tpuRuntimeEnableExternalSsh=False"):
        ours = values.parse_set_flag(ours, assignment)
        theirs = jvalues.parse_set_flag(theirs, assignment)
    ours = values.parse_set_file_flag(ours, f"jaxRuntimeConfig={path}")
    theirs = jvalues.parse_set_file_flag(theirs, f"jaxRuntimeConfig={path}")
    for field in ("nameOverride", "tpuRuntimeDiskSize",
                  "tpuRuntimeEnableExternalSsh", "jaxRuntimeConfig"):
        assert getattr(ours, field) == getattr(theirs, field)
    with pytest.raises(ValueError, match="cannot be set from a file"):
        values.parse_set_file_flag(
            ours, f"tpuRuntimeEnableExternalSsh={path}")


# ---- the boot document ---------------------------------------------------


@pytest.mark.parametrize("key", ["", "ssh-ed25519 AAAA me@host",
                                 "ssh-rsa K a&b<c>d", 'k: "#x"'])
def test_boot_document_is_the_references_but_for_the_image_comment(key):
    ours = bootconfig.boot_config_document(
        DEFAULT_VALUES.replace(publicSshKey=key))
    theirs = jbootconfig.boot_config_document(
        jvalues.DEFAULT_VALUES.replace(publicSshKey=key))
    assert ours == theirs.replace(JAX_IMAGE_COMMENT, PORT_IMAGE_COMMENT)
    assert ours != theirs
    for parse in (bootdoc.parse_boot_document,
                  jbootdoc.parse_boot_document):
        assert parse(ours) == parse(theirs)
    for name in ("CONFIG_SERIAL", "DISKS_ROOT", "APP_SECRET_MOUNT",
                 "BOOT_SECRET_MOUNT", "RUNTIME_HOSTNAME", "HEADER"):
        assert getattr(bootconfig, name) == getattr(jbootconfig, name)
    assert '"kvedge-runtime boot --config /etc/kvedge/config.toml"' in ours
